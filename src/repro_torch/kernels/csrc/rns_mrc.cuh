// MRC normalization of one value held as K residues in registers, shared
// by rns_normalize.cu and the fused kernels' epilogue (rns_fused_mma.cu).
// Steps, as core/mrc.decode_float: MRC digits; sign = digits >= those of
// M/2 (lexicographic, most significant last); magnitude = (m - r) mod m
// for negatives; MRC of the magnitude; sum_j d_j * float32(W_j)
// digit-ascending with __fmul_rn / __fadd_rn, so nvcc cannot contract the
// sum into FMAs (an FMA changes the last bit, ROADMAP C.1); negate.
// K is a template parameter so the digit loops unroll into registers.
// MULHI (taken by the fused kernels of rns_fused_mma.cu) reduces the MRC
// terms (r_j - d_i) * inv, within +-65536 since m <= 256, by mulhi_mod
// after the offset moff_j, a multiple of m_j, makes them non-negative,
// in place of floor_mod's division: the same integers, so the same float.
#pragma once

#include "rns_tables.cuh"

template <int K, bool MULHI = false>
__device__ __forceinline__ void mrc_digits(const int (&r_in)[K], int (&d)[K],
                                           const RnsTables& t) {
  int r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = r_in[j];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    d[i] = r[i];
#pragma unroll
    for (int j = i + 1; j < K; ++j) {
      const int v = (r[j] - d[i]) * t.inv[i * RNS_MAX_K + j];
      r[j] = MULHI ? mulhi_mod(v + t.moff[j], t.moduli[j], t.magic[j])
                   : floor_mod(v, t.moduli[j]);
    }
  }
}

// residues r[j] in [0, m_j) -> the signed value as float32 (unscaled)
template <int K, bool MULHI = false>
__device__ __forceinline__ float mrc_decode_float(int (&r)[K],
                                                  const RnsTables& t) {
  int d[K];
  mrc_digits<K, MULHI>(r, d, t);
  bool ge = false, eq = true;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    ge = ge || (eq && d[j] > t.half[j]);
    eq = eq && d[j] == t.half[j];
  }
  const bool neg = ge || eq;
  if (neg) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      r[j] = MULHI ? (r[j] ? t.moduli[j] - r[j] : 0)
                   : floor_mod(t.moduli[j] - r[j], t.moduli[j]);
  }
  mrc_digits<K, MULHI>(r, d, t);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    acc = __fadd_rn(acc, __fmul_rn((float)d[j], t.w[j]));
  return neg ? -acc : acc;
}
