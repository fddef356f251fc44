// External-validation harness around the *reference* implementation
// (/root/reference, compiled in place with an MKL type stub; see mkl.h).
//
// This is the independent oracle VERDICT.md round 1 asked for: it drives
// the reference's own decoders/modem/quantizers with fully controlled
// inputs so faid can be diffed bit-for-bit against the real thing
// instead of against builder-written re-derivations.
//
// Modes (all buffers little-endian binary files):
//   decode <method 0-5> <max_iter> <n_words> <in.i8> <out.i8>
//       in : n_words x [32 x 14592 info | 32 x 3072 check] int8 LLRs
//            (the reference fixInput layout, CDecoder_FAID.cpp:212-241)
//       out: n_words x [32 x 17664] int8 hard bits, frame-major
//            (decodedBits, CLDPC.h:125)
//   quant <bits 1-6> <scale> <n> <in.f32> <out.i8>
//       float2LimitChar_{bits}bit (CLDPC.cpp:4385-4770)
//   mod <mod_type> <depth> <in_bits.i8> <out_iq.f32>
//       in : [32 x 14592 | 32 x 3072] int8 bits (outputBits layout)
//       out: SymbolLen x {I,Q} float pairs (CModulate.cpp:216-264 after
//            BeforeModulationInterleaver :95-152)
//   demod <mod_type> <depth> <in_iq.f32> <out.f32>
//       in : SymbolLen x {I,Q} float pairs
//       out: 32*17664 floats, DeInterLeaveSeq layout = fixInput layout
//            (Demodulation :270-362 + AfterDeModulationDeInterleaver
//            :156-212)
//   fer <method> <max_iter> <sigma> <scale> <n_rounds> <seed> [mod_type] [depth]
//       FakeEncoder (all-zero codeword) Monte-Carlo with std::mt19937
//       noise; prints JSON counters.  Reproduces CSimulate::Run
//       (CSimulate.cpp:92-180) without CSimulate.cpp (which has a stray
//       token at :123) and without MKL RNG.
//
// Profile.txt must exist in cwd: every reference decoder re-reads it for
// Factor_1/Factor_2 (e.g. CDecoder_FAID.cpp:179).
#include "CLDPC.h"
#include "CModulate.h"
#include <cstdio>
#include <random>
#include <string>
#include <vector>

int collectflag = 0; // normally defined in main.cpp:14

static void die(const char* msg)
{
    fprintf(stderr, "harness: %s\n", msg);
    exit(1);
}

static std::vector<char> read_file(const char* path, size_t expect)
{
    FILE* f = fopen(path, "rb");
    if (!f) die("cannot open input");
    std::vector<char> buf(expect);
    if (fread(buf.data(), 1, expect, f) != expect) die("short read");
    fclose(f);
    return buf;
}

static int run_decode(CLDPC& ldpc, int method)
{
    switch (method) {
    case 0: ldpc.Decode(); break;
    case 1: ldpc.Decode_OMS(); break;
    case 2: ldpc.Decode_FAID(); break;
    case 3: return ldpc.Decode_OMSBF();
    case 4: return ldpc.Decode_OMS_DTBF();
    case 5: ldpc.Decode_FAID_2B1C(); break;
    default: die("bad method");
    }
    return -1;
}

int main(int argc, char** argv)
{
    if (argc < 2) die("usage: harness <mode> ...");
    std::string mode = argv[1];
    const size_t FR = 32, N = NOEUD, CHAN = (size_t)BitsOverChannel;

    if (mode == "decode") {
        if (argc != 7) die("decode <method> <max_iter> <n_words> <in> <out>");
        int method = atoi(argv[2]), max_iter = atoi(argv[3]);
        long n_words = atol(argv[4]);
        CLDPC ldpc;
        ldpc.Initial((int)FR, max_iter);
        FILE* fi = fopen(argv[5], "rb");
        FILE* fo = fopen(argv[6], "wb");
        if (!fi || !fo) die("cannot open files");
        for (long w = 0; w < n_words; ++w) {
            if (fread(ldpc.fixInput, 1, FR * CHAN, fi) != FR * CHAN)
                die("short read");
            run_decode(ldpc, method);
            fwrite(ldpc.decodedBits, 1, FR * N, fo);
        }
        fclose(fi);
        fclose(fo);
        return 0;
    }

    if (mode == "quant") {
        if (argc != 7) die("quant <bits> <scale> <n> <in> <out>");
        int bits = atoi(argv[2]);
        float scale = (float)atof(argv[3]);
        long n = atol(argv[4]);
        // Quantizers process 32 bytes per vector op; pad to a multiple.
        long np = (n + 31) / 32 * 32;
        std::vector<char> in = read_file(argv[5], n * sizeof(float));
        std::vector<float> fin(np, 0.0f);
        memcpy(fin.data(), in.data(), n * sizeof(float));
        int8_t* out = (int8_t*)vec_malloc((uint32_t)np);
        CLDPC ldpc;
        ldpc.Initial((int)FR, 6);
        switch (bits) {
        case 6: ldpc.float2LimitChar_6bit(out, fin.data(), scale, (int)np); break;
        case 5: ldpc.float2LimitChar_5bit(out, fin.data(), scale, (int)np); break;
        case 4: ldpc.float2LimitChar_4bit(out, fin.data(), scale, (int)np); break;
        case 3: ldpc.float2LimitChar_3bit(out, fin.data(), scale, (int)np); break;
        case 2: ldpc.float2LimitChar_2bit(out, fin.data(), scale, (int)np); break;
        case 1: ldpc.float2LimitChar_1bit(out, fin.data(), scale, (int)np); break;
        default: die("bad bits");
        }
        FILE* fo = fopen(argv[6], "wb");
        fwrite(out, 1, n, fo);
        fclose(fo);
        return 0;
    }

    if (mode == "mod" || mode == "demod") {
        if (argc != 6) die("mod|demod <mod_type> <depth> <in> <out>");
        int mod_type = atoi(argv[2]), depth = atoi(argv[3]);
        CModulate m;
        m.ModulationType = mod_type;
        m.InterleaveModType = depth;
        m.Initial(FR * CHAN);
        FILE* fo = fopen(argv[5], "wb");
        if (!fo) die("cannot open output");
        if (mode == "mod") {
            std::vector<char> bits = read_file(argv[4], FR * CHAN);
            m.BeforeModulationInterleaver((int8_t*)bits.data());
            m.Modulation(m.InterLeaveSeq);
            fwrite(m.ModSeq, sizeof(MKL_Complex8), m.SymbolLen, fo);
        } else {
            std::vector<char> sym =
                read_file(argv[4], m.SymbolLen * sizeof(MKL_Complex8));
            m.Demodulation((MKL_Complex8*)sym.data());
            m.AfterDeModulationDeInterleaver();
            fwrite(m.DeInterLeaveSeq, sizeof(float), FR * CHAN, fo);
        }
        fclose(fo);
        return 0;
    }

    if (mode == "itercount") {
        // Reproduce the reference's iterCount.txt writer byte-for-byte
        // (CSimulate.cpp:97-99, 149-155, 171-179): one histogram bump of
        // the decoder's returned BF round count per 32-frame word
        // (methods 3/4; an up-counter = rounds used, CDecoder_OMSBF.cpp
        // :2968-3510), then "i: count" lines for the nonzero buckets
        // 1..50, written to stdout.
        if (argc != 6) die("itercount <method 3|4> <max_iter> <n_words> <in.i8>");
        int method = atoi(argv[2]), max_iter = atoi(argv[3]);
        long n_words = atol(argv[4]);
        if (method != 3 && method != 4) die("itercount needs method 3 or 4");
        CLDPC ldpc;
        ldpc.Initial((int)FR, max_iter);
        FILE* fi = fopen(argv[5], "rb");
        if (!fi) die("cannot open input");
        long BFiters_[51] = { 0 };
        for (long w = 0; w < n_words; ++w) {
            if (fread(ldpc.fixInput, 1, FR * CHAN, fi) != FR * CHAN)
                die("short read");
            int bfiter = run_decode(ldpc, method);
            if (bfiter >= 0 && bfiter <= 50) BFiters_[bfiter]++;
        }
        fclose(fi);
        for (int i = 1; i <= 50; i++)
            if (BFiters_[i] != 0) printf("%d: %ld\n", i, BFiters_[i]);
        return 0;
    }

    if (mode == "fer") {
        if (argc < 8) die("fer <method> <max_iter> <sigma> <scale> <n_rounds> <seed> [mod_type=1] [depth=1]");
        int method = atoi(argv[2]), max_iter = atoi(argv[3]);
        float sigma = (float)atof(argv[4]), scale = (float)atof(argv[5]);
        long n_rounds = atol(argv[6]);
        unsigned seed = (unsigned)atol(argv[7]);
        int mod_type = argc > 8 ? atoi(argv[8]) : 1;
        int depth = argc > 9 ? atoi(argv[9]) : 1;
        CLDPC ldpc;
        ldpc.Initial((int)FR, max_iter);
        CModulate m;
        m.ModulationType = mod_type;
        m.InterleaveModType = depth;
        m.Initial(FR * CHAN);
        ldpc.FakeEncoder();
        std::mt19937 rng(seed);
        std::normal_distribution<float> gauss(0.0f, 1.0f);
        unsigned long test = 0, errf = 0, errb = 0, lt3 = 0;
        std::vector<float> noisy(FR * CHAN);
        if (mod_type == 1) {
            m.BPSKModulation(ldpc.outputBits);
        } else {
            m.BeforeModulationInterleaver(ldpc.outputBits);
            m.Modulation(m.InterLeaveSeq);
        }
        std::vector<MKL_Complex8> nsym(m.SymbolLen);
        for (long r = 0; r < n_rounds; ++r) {
            test += FR;
            if (mod_type == 1) {
                for (size_t i = 0; i < FR * CHAN; ++i)
                    noisy[i] = m.BPSKModSeq[i] + sigma * gauss(rng);
                ldpc.float2LimitChar_4bit(ldpc.fixInput, noisy.data(), scale,
                                          (int)(FR * CHAN));
            } else {
                float s = sigma / sqrtf(2.0f);
                for (size_t i = 0; i < m.SymbolLen; ++i) {
                    nsym[i].real = m.ModSeq[i].real + s * gauss(rng);
                    nsym[i].imag = m.ModSeq[i].imag + s * gauss(rng);
                }
                m.Demodulation(nsym.data());
                m.AfterDeModulationDeInterleaver();
                ldpc.float2LimitChar_4bit(ldpc.fixInput, m.DeInterLeaveSeq,
                                          scale, (int)(FR * CHAN));
            }
            run_decode(ldpc, method);
            Statistic st = ldpc.CalculateErrors(
                mod_type == 1 ? noisy.data() : m.DeInterLeaveSeq,
                ldpc.fixInput, 0);
            errf += st.ErrorFrame;
            errb += st.ErrorBits;
            lt3 += st.LT3ErrBitFrame;
        }
        printf("{\"test_frames\": %lu, \"error_frames\": %lu, "
               "\"error_bits\": %lu, \"lt3_frames\": %lu}\n",
               test, errf, errb, lt3);
        return 0;
    }

    die("unknown mode");
}
