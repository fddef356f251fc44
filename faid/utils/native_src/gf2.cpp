// Bit-packed GF(2) linear algebra for code-matrix tooling.
//
// The reference ships its encoder as a precomputed sparse generator table
// (GenMatrix, reference Constants_SSE.h:3106) whose data blobs are missing;
// we reconstruct the systematic encoder by solving  p = (H_p^{-1} H_i) u
// over GF(2) (see faid/code/encoder.py).  The elimination over the
// [H_p | H_i] augmented matrix (3072 x 17664 for 50G-PON) is the hot host
// step; this native version packs rows into uint64 words and eliminates
// word-wise (~64x the numpy row loop), mirroring how the reference keeps
// its host-side tooling in C++.
//
// Exported (C ABI, used via ctypes from faid/utils/native.py):
//   gf2_solve_parity(h, n_chk, n_var, n_info, out_p) -> 0 ok / -1 singular
//   gf2_matmul_mod2(a, b, m, k, n, out)              C = A*B mod 2
//   gf2_syndrome_weight(h, c, n_chk, n_var, batch, out)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int word_count(int bits) { return (bits + 63) / 64; }

// Pack a row-major uint8 {0,1} matrix into per-row uint64 words.
void pack(const uint8_t* a, int rows, int cols, std::vector<uint64_t>& out,
          int words) {
  out.assign(static_cast<size_t>(rows) * words, 0);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = a + static_cast<size_t>(r) * cols;
    uint64_t* dst = out.data() + static_cast<size_t>(r) * words;
    for (int c = 0; c < cols; ++c)
      if (src[c] & 1) dst[c >> 6] |= (uint64_t)1 << (c & 63);
  }
}

}  // namespace

extern "C" {

// Solve P such that parity = P * info over GF(2), where
// H = [H_i | H_p] (info columns first).  h: [n_chk, n_var] uint8 {0,1},
// out_p: [n_chk, n_info] uint8.  Returns 0, or -1 if H_p is singular.
int gf2_solve_parity(const uint8_t* h, int n_chk, int n_var, int n_info,
                     uint8_t* out_p) {
  const int aug_cols = n_chk + n_info;  // [H_p | H_i]
  const int words = word_count(aug_cols);

  // Build augmented rows: parity part first so pivots are the left block.
  std::vector<uint64_t> aug(static_cast<size_t>(n_chk) * words, 0);
  for (int r = 0; r < n_chk; ++r) {
    const uint8_t* src = h + static_cast<size_t>(r) * n_var;
    uint64_t* dst = aug.data() + static_cast<size_t>(r) * words;
    for (int c = 0; c < n_chk; ++c)   // H_p columns
      if (src[n_info + c] & 1) dst[c >> 6] |= (uint64_t)1 << (c & 63);
    for (int c = 0; c < n_info; ++c)  // H_i columns
      if (src[c] & 1) {
        int cc = n_chk + c;
        dst[cc >> 6] |= (uint64_t)1 << (cc & 63);
      }
  }

  // Gauss-Jordan to reduced row echelon form on the left block.
  for (int col = 0; col < n_chk; ++col) {
    const int w = col >> 6;
    const uint64_t mask = (uint64_t)1 << (col & 63);
    int piv = -1;
    for (int r = col; r < n_chk; ++r)
      if (aug[static_cast<size_t>(r) * words + w] & mask) { piv = r; break; }
    if (piv < 0) return -1;  // singular
    if (piv != col)
      for (int k = 0; k < words; ++k)
        std::swap(aug[static_cast<size_t>(col) * words + k],
                  aug[static_cast<size_t>(piv) * words + k]);
    const uint64_t* prow = aug.data() + static_cast<size_t>(col) * words;
    for (int r = 0; r < n_chk; ++r) {
      if (r == col) continue;
      uint64_t* row = aug.data() + static_cast<size_t>(r) * words;
      if (row[w] & mask)
        for (int k = w; k < words; ++k) row[k] ^= prow[k];
    }
  }

  // Right block rows are P.
  for (int r = 0; r < n_chk; ++r) {
    const uint64_t* row = aug.data() + static_cast<size_t>(r) * words;
    uint8_t* dst = out_p + static_cast<size_t>(r) * n_info;
    for (int c = 0; c < n_info; ++c) {
      int cc = n_chk + c;
      dst[c] = (row[cc >> 6] >> (cc & 63)) & 1;
    }
  }
  return 0;
}

// C = A * B mod 2.  a: [m, k] uint8, b: [k, n] uint8, out: [m, n] uint8.
void gf2_matmul_mod2(const uint8_t* a, const uint8_t* b, int m, int k, int n,
                     uint8_t* out) {
  const int words = word_count(n);
  std::vector<uint64_t> bp;
  pack(b, k, n, bp, words);
  std::vector<uint64_t> acc(words);
  for (int i = 0; i < m; ++i) {
    std::memset(acc.data(), 0, words * sizeof(uint64_t));
    const uint8_t* arow = a + static_cast<size_t>(i) * k;
    for (int j = 0; j < k; ++j)
      if (arow[j] & 1) {
        const uint64_t* brow = bp.data() + static_cast<size_t>(j) * words;
        for (int w = 0; w < words; ++w) acc[w] ^= brow[w];
      }
    uint8_t* dst = out + static_cast<size_t>(i) * n;
    for (int c = 0; c < n; ++c) dst[c] = (acc[c >> 6] >> (c & 63)) & 1;
  }
}

// Per-frame count of unsatisfied checks.  h: [n_chk, n_var], c: [batch,
// n_var], out: [batch] int32.
void gf2_syndrome_weight(const uint8_t* h, const uint8_t* c, int n_chk,
                         int n_var, int batch, int32_t* out) {
  const int words = word_count(n_var);
  std::vector<uint64_t> hp, cp;
  pack(h, n_chk, n_var, hp, words);
  pack(c, batch, n_var, cp, words);
  for (int f = 0; f < batch; ++f) {
    const uint64_t* crow = cp.data() + static_cast<size_t>(f) * words;
    int32_t bad = 0;
    for (int r = 0; r < n_chk; ++r) {
      const uint64_t* hrow = hp.data() + static_cast<size_t>(r) * words;
      uint64_t parity = 0;
      for (int w = 0; w < words; ++w) parity ^= hrow[w] & crow[w];
      bad += __builtin_parityll(parity);
    }
    out[f] = bad;
  }
}

}  // extern "C"
