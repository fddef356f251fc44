/* Minimal MKL stand-in so the reference sources compile with g++ on this
 * host (no Intel MKL installed).  Only the *types* referenced by the
 * reference headers are needed by the files we link (CLDPC.cpp, the five
 * CDecoder_*.cpp, CTool.cpp, CModulate.cpp): MKL_Complex8 members
 * (CModulate.cpp:227-362) and the VSLStreamStatePtr member of CChannel
 * (CChannel.h:37).  CChannel.cpp itself — the only file that *calls* MKL
 * RNG functions — is not linked; the harness generates noise with
 * <random>.
 */
#ifndef FAID_REFCHECK_MKL_STUB_H
#define FAID_REFCHECK_MKL_STUB_H

typedef struct {
    float real;
    float imag;
} MKL_Complex8;

typedef void* VSLStreamStatePtr;

#endif
