// MRC normalization of one value held as K residues in registers, shared
// by rns_normalize.cu and the fused kernels' epilogue (rns_fused.cu).
// Steps, as core/mrc.decode_float: MRC digits; sign = digits >= those of
// M/2 (lexicographic, most significant last); magnitude = (m - r) mod m
// for negatives; MRC of the magnitude; sum_j d_j * float32(W_j)
// digit-ascending with __fmul_rn / __fadd_rn, so nvcc cannot contract the
// sum into FMAs (an FMA changes the last bit, ROADMAP C.1); negate.
// K is a template parameter so the digit loops unroll into registers.
#pragma once

#include "rns_tables.cuh"

template <int K>
__device__ __forceinline__ void mrc_digits(const int (&r_in)[K], int (&d)[K],
                                           const RnsTables& t) {
  int r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = r_in[j];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    d[i] = r[i];
#pragma unroll
    for (int j = i + 1; j < K; ++j)
      r[j] = floor_mod((r[j] - d[i]) * t.inv[i * RNS_MAX_K + j], t.moduli[j]);
  }
}

// residues r[j] in [0, m_j) -> the signed value as float32 (unscaled)
template <int K>
__device__ __forceinline__ float mrc_decode_float(int (&r)[K],
                                                  const RnsTables& t) {
  int d[K];
  mrc_digits<K>(r, d, t);
  bool ge = false, eq = true;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    ge = ge || (eq && d[j] > t.half[j]);
    eq = eq && d[j] == t.half[j];
  }
  const bool neg = ge || eq;
  if (neg) {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = floor_mod(t.moduli[j] - r[j], t.moduli[j]);
  }
  mrc_digits<K>(r, d, t);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    acc = __fadd_rn(acc, __fmul_rn((float)d[j], t.w[j]));
  return neg ? -acc : acc;
}
