// Native scalar golden decoder - a C++ mirror of the numpy oracle
// (faid/golden/model.py), walking the flat CN->VN edge list exactly
// like the reference's PosNoeudsVariable loop (reference CLDPC.cpp:276-406).
//
// Purpose: a fast test oracle.  The chain of evidence is
//   numpy golden  ==  native golden  ==  JAX (xla)
// where the first equality is checked on a few frames (both scalar
// re-derivations) and the fast native oracle then covers many frames.
//
// Exported (C ABI, ctypes):
//   golden_decode(...) - one frame, all six reference decode methods.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int clip8(int x) { return x < -128 ? -128 : (x > 127 ? 127 : x); }

constexpr int SAT_POS_VAR = 31, SAT_NEG_VAR = -31, SAT_POS_MSG = 7;

struct Syndrome {
  std::vector<uint8_t> unsat;   // [n_chk]
  std::vector<int32_t> votes;   // [n_var]
  int count = 0;
};

void syndrome_from(const int32_t* en_or_hard, bool hard_input,
                   const int32_t* edges, const int32_t* degrees, int n_chk,
                   int n_var, Syndrome& s) {
  s.unsat.assign(n_chk, 0);
  s.votes.assign(n_var, 0);
  s.count = 0;
  const int32_t* e = edges;
  for (int cn = 0; cn < n_chk; ++cn) {
    int deg = degrees[cn];
    int par = 0;
    for (int j = 0; j < deg; ++j) {
      int v = e[j];
      par ^= hard_input ? (en_or_hard[v] & 1) : (en_or_hard[v] > 0 ? 1 : 0);
    }
    if (par) {
      s.unsat[cn] = 1;
      s.count++;
      for (int j = 0; j < deg; ++j) s.votes[e[j]]++;
    }
    e += deg;
  }
}

}  // namespace

extern "C" {

// style: 0 nms, 1 oms, 2 faid.  bf_kind: 0 none, 1 static, 2 dtbf,
// 3 dtbf2b1c.  lut/lut_ef: [max_iter * 8] int8 (faid only, else null).
void golden_decode(
    const int32_t* edges, const int32_t* degrees, const int32_t* vn_weight,
    int n_var, int n_chk, int n_edges, const int8_t* llr_in,
    int style, int max_iter, int factor_1, int factor_2, int oms_mode,
    int oms_offset, int stop_early, int ef_elim, int floor_err_count,
    int floor_iter_thresh, int sign_backtrack,
    const int8_t* lut, const int8_t* lut_ef, int puncture_tail,
    int bf_kind, int bf_max_iter, int bf_delta, int bf_l0, int bf_l1,
    int bf_alpha, int bf_gamma, int bf_vote_cap, int bf_rel_thresh,
    uint8_t* hard_out, int32_t* mp_iters_out, int32_t* bf_rounds_out) {
  std::vector<int32_t> en(n_var);
  for (int i = 0; i < n_var; ++i) en[i] = llr_in[i];
  for (int i = n_var - puncture_tail; i < n_var; ++i) en[i] = 0;
  std::vector<int32_t> msgs(n_edges, 0);

  Syndrome syn;
  std::vector<uint8_t> era(n_var);
  std::vector<int32_t> vc(64), mag(64);
  std::vector<uint8_t> neg(64);

  int mp_iters = 0;
  for (int it = 0; it < max_iter; ++it) {
    bool l_m_err = false;
    bool have_syn = false;
    if (stop_early) {
      syndrome_from(en.data(), false, edges, degrees, n_chk, n_var, syn);
      have_syn = true;
      if (syn.count == 0) break;
      l_m_err = syn.count < floor_err_count;
    }
    mp_iters++;
    int remaining = max_iter - 1 - it;
    bool in_floor = remaining <= floor_iter_thresh;
    std::fill(era.begin(), era.end(), 0);

    const int8_t* lut_row = lut ? lut + it * 8 : nullptr;
    const int8_t* lut_ef_row = lut_ef ? lut_ef + it * 8 : nullptr;

    const int32_t* e = edges;
    int off = 0;
    for (int cn = 0; cn < n_chk; ++cn) {
      int deg = degrees[cn];
      bool odd = deg & 1;

      // pass 1
      int par = 0;
      for (int j = 0; j < deg; ++j) {
        int v = e[j];
        int x = clip8(en[v] - msgs[off + j]);
        if (x < SAT_NEG_VAR) x = SAT_NEG_VAR;
        if (style == 2) {
          if (x > SAT_POS_VAR) x = SAT_POS_VAR;
          if (ef_elim == 2 && in_floor && vn_weight[v] == 3 &&
              have_syn && syn.votes[v] >= 3 && l_m_err && !era[v]) {
            x = 0;
            era[v] = 1;
          }
        }
        vc[j] = x;
        int sgn_src = x;
        if (style == 2 && sign_backtrack && x == 0) sgn_src = en[v];
        neg[j] = sgn_src < 0;
        par ^= neg[j];
      }

      // magnitudes
      bool cn_unsat = have_syn && syn.unsat[cn];
      for (int j = 0; j < deg; ++j) {
        int a = vc[j] < 0 ? -vc[j] : vc[j];
        if (style == 2) {
          int idx = a > 7 ? 7 : a;
          int m = lut_row[idx];
          if (ef_elim >= 1 && in_floor && l_m_err && cn_unsat)
            m = lut_ef_row[idx];
          mag[j] = m;
        } else if (style == 1) {
          mag[j] = a > SAT_POS_MSG ? SAT_POS_MSG : a;
        } else {
          mag[j] = a;
        }
      }

      int min1 = SAT_POS_VAR, min2 = SAT_POS_VAR;
      for (int j = 0; j < deg; ++j) {
        int m = mag[j];
        int hi = m > min1 ? m : min1;
        if (hi < min2) min2 = hi;
        if (m < min1) min1 = m;
      }

      int c1, c2;
      if (style == 0) {
        c2 = clip8((min1 * factor_1) >> 5);
        if (c2 > SAT_POS_MSG) c2 = SAT_POS_MSG;
        c1 = clip8((min2 * factor_2) >> 5);
        if (c1 > SAT_POS_MSG) c1 = SAT_POS_MSG;
      } else if (style == 2 || oms_mode == 0) {
        c1 = min2 - oms_offset;
        if (c1 > SAT_POS_MSG) c1 = SAT_POS_MSG;
        c2 = min1 - oms_offset;
        if (c2 > SAT_POS_MSG) c2 = SAT_POS_MSG;
      } else {
        auto offsel = [&](int m) {
          if (in_floor && cn_unsat && l_m_err) {
            m += (m < factor_2) ? 1 : 0;
            m += (m <= factor_1) ? 1 : 0;
          } else {
            m -= (m > factor_1) ? 1 : 0;
            m -= (m >= factor_2) ? 1 : 0;
          }
          return m;
        };
        c1 = offsel(min2);
        if (c1 > SAT_POS_MSG) c1 = SAT_POS_MSG;
        c2 = offsel(min1);
        if (c2 > SAT_POS_MSG) c2 = SAT_POS_MSG;
      }

      // pass 2
      for (int j = 0; j < deg; ++j) {
        int cmp = (style == 2) ? mag[j] : (vc[j] < 0 ? -vc[j] : vc[j]);
        int vres = (cmp == min1) ? c1 : c2;
        bool n = (par ^ neg[j] ^ (odd ? 1 : 0)) != 0;
        int nm = n ? -vres : vres;
        msgs[off + j] = nm;
        int env = clip8(vc[j] + nm);
        if (env < SAT_NEG_VAR) env = SAT_NEG_VAR;
        if (env > SAT_POS_VAR) env = SAT_POS_VAR;
        en[e[j]] = env;
      }
      e += deg;
      off += deg;
    }
  }

  std::vector<uint8_t> hard(n_var), hard_ch(n_var), hard2(n_var, 0);
  for (int i = 0; i < n_var; ++i) hard[i] = en[i] > 0;
  int bf_rounds = 0;

  if (bf_kind == 1) {  // static BF
    for (int r = 0; r < bf_max_iter; ++r) {
      std::vector<int32_t> h32(n_var);
      for (int i = 0; i < n_var; ++i) h32[i] = hard[i];
      syndrome_from(h32.data(), true, edges, degrees, n_chk, n_var, syn);
      if (syn.count == 0) break;
      int max_vote = 1;
      for (int i = 0; i < n_var; ++i)
        if (syn.votes[i] > max_vote) max_vote = syn.votes[i];
      int thresh = max_vote < bf_vote_cap ? max_vote : bf_vote_cap;
      for (int i = 0; i < n_var; ++i)
        if (syn.votes[i] >= thresh) hard[i] ^= 1;
      bf_rounds++;
    }
  } else if (bf_kind == 2 || bf_kind == 3) {  // DTBF / 2B1C
    hard_ch = hard;
    if (bf_kind == 3)
      for (int i = 0; i < n_var; ++i)
        hard2[i] = (en[i] >= bf_rel_thresh || en[i] <= -bf_rel_thresh);
    int Th = bf_gamma, l0 = 0, l1 = 0;
    bool t = true;
    for (int r = 0; r < bf_max_iter; ++r) {
      std::vector<int32_t> h32(n_var);
      for (int i = 0; i < n_var; ++i) h32[i] = hard[i];
      syndrome_from(h32.data(), true, edges, degrees, n_chk, n_var, syn);
      if (syn.count == 0) break;
      bf_rounds++;
      if (!t) Th -= bf_delta;
      if (t && l0 < bf_l0) {
        Th = bf_gamma + bf_alpha;
        l0++;
      } else if (t && l1 < bf_l1) {
        Th = bf_gamma + bf_alpha - bf_delta;
        l1++;
      } else if (t) {
        Th = bf_gamma + bf_alpha - 2 * bf_delta;
      }
      if (Th < 1) Th = 1;

      bool any_flip = false;
      for (int i = 0; i < n_var; ++i) {
        if (vn_weight[i] != bf_gamma) continue;
        int score = syn.votes[i] + bf_alpha * (hard[i] ^ hard_ch[i]);
        if (score < Th) continue;
        any_flip = true;
        if (bf_kind == 3) {
          if (Th >= bf_gamma) {  // big jump: flip both bits
            hard[i] ^= 1;
            hard2[i] ^= 1;
          } else {               // small jump: demote or flip
            if (!hard2[i]) hard[i] ^= 1;
            else hard2[i] = 0;
          }
        } else {
          hard[i] ^= 1;
        }
      }
      t = any_flip;
    }
  }

  std::memcpy(hard_out, hard.data(), n_var);
  *mp_iters_out = mp_iters;
  *bf_rounds_out = bf_rounds;
}

}  // extern "C"
