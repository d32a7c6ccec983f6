// MRC normalization of one value held as K residues in registers, shared
// by rns_normalize.cu and the fused kernels' epilogue (rns_fused_mma.cu).
// The same float as core/mrc.decode_float, in one MRC pass:
//
// * Input contract: residues r_j in [0, m_j) (every producer reduces:
//   rns_convert, rns_matmul, the fused kernels' own tiles).
// * MRC digits in place: r_j <- (r_j - d_i) * inv_ij mod m_j for j > i,
//   by mrc_term: no division, three integer instructions, the same
//   integers as a floor-mod.
// * Sign: digits >= those of M/2 (lexicographic, most significant last),
//   as the borrow out of X - M/2 taken digit by digit: none means X >= M/2.
// * Magnitude of a negative X without a second MRC: M - 1 has the digits
//   m_j - 1, so M - 1 - X has m_j - 1 - d_j (no borrow), and M - X is
//   that plus one, the carry run digit-ascending.  Mixed-radix digits are
//   unique, so these are the digits an MRC of (m_j - r_j) mod m_j gives.
// * sum_j g_j * float32(W_j) digit-ascending with __fmul_rn / __fadd_rn,
//   so nvcc cannot contract the sum into FMAs (an FMA changes the last
//   bit, ROADMAP C.1); negate last.
// K is a template parameter so the digit loops unroll into registers.
#pragma once

#include "rns_tables.cuh"

// (r_j - r_i) * inv_ij mod m_j for r_j < m_j and r_i < 256, with no
// division (Lemire, Kaser and Kurz's direct remainder): x = (r_j - r_i +
// roff_j) * inv_ij is congruent, non-negative and below 2^18, and its
// remainder is the high word of (x * ceil(2^32 / m_j) mod 2^32) * m_j,
// exact while x * m_j < 2^26 <= 2^32 (the fraction's 32 bits cover the
// bits of x and of m_j).  The low word x * ceil(2^32 / m_j) is (r_j - r_i
// + roff_j) times the table's mrc_c, which holds inv_ij already: one add,
// one multiply-low, one multiply-high.
__device__ __forceinline__ int mrc_term(int rj, int ri, int i, int j,
                                        const RnsTables& t) {
  const unsigned lo =
      (unsigned)(rj - ri + t.roff[j]) * t.mrc_c[RNS_PAIR(i, j)];
  return (int)__umulhi(lo, (unsigned)t.moduli[j]);
}

// float(g) for 0 <= g < 2^23 on the integer and float32 pipes (OR the
// bits into 2^23's mantissa, subtract 2^23) in place of an I2F, which
// issues at a quarter of the integer rate: exact, so the same float
__device__ __forceinline__ float digit_float(int g) {
  return __fsub_rn(__int_as_float(0x4B000000 | g), 8388608.0f);
}

// residues r[j] in [0, m_j) -> the signed value as float32 (unscaled);
// r is overwritten with the MRC digits
template <int K>
__device__ __forceinline__ float mrc_decode_float(int (&r)[K],
                                                  const RnsTables& t) {
#pragma unroll
  for (int i = 0; i < K - 1; ++i)
#pragma unroll
    for (int j = i + 1; j < K; ++j)
      r[j] = mrc_term(r[j], r[i], i, j, t);
  int borrow = 0;                   // of X - M/2, digit-ascending: 0, -1
#pragma unroll
  for (int j = 0; j < K; ++j) borrow = (r[j] - t.half[j] + borrow) >> 31;
  const bool neg = borrow == 0;     // X >= M/2
  int carry = 1;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int g = t.moduli[j] - 1 - r[j] + carry;   // digit j of M - X
    carry = g == t.moduli[j];
    g = neg ? (carry ? 0 : g) : r[j];
    acc = __fadd_rn(acc, __fmul_rn(digit_float(g), t.w[j]));
  }
  return neg ? -acc : acc;
}
