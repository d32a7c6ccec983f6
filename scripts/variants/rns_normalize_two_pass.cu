// Design candidate, built only by scripts/kernel_variants.py (study
// normalize_design): the MRC normalization as it ran before the one-pass
// kernel (src/repro_torch/kernels/rns_normalize/csrc/rns_normalize.cu),
// kept to be measured beside it.  [K, T] int32 residues -> [T] float32,
// one element a thread, scalar loads; two MRC passes an element: the
// digits of X for the sign, then, for a negative X, the residues of M - X
// ((m - r) mod m) through a second MRC.  MULHI = false reduces every MRC
// term (r_j - d_i) * inv by floor_mod (C's % by a runtime modulus);
// MULHI = true by the offset multiply-high mod mulhi_mod (the same
// integers).  PASSES = 1 takes the magnitude's digits from the first pass
// instead (the complement m_j - 1 - d_j plus a carried one, as the
// shipped kernel).  The float sum is digit-ascending with __fmul_rn /
// __fadd_rn, as core/mrc.decode_float.  Same C entry as the shipped
// kernel.  The inverses inv_ij = m_i^-1 mod m_j are not in RnsTables (the
// shipped MRC folds them into mrc_c): the host derives them once per set
// of moduli and passes them by value beside the tables.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rns_tables.cuh"

constexpr bool MULHI = false;
constexpr int PASSES = 2;

struct InvTables {
  int inv[RNS_MAX_K * RNS_MAX_K];   // inv[i*RNS_MAX_K+j] = m_i^-1 mod m_j
};

// the inverses of t's moduli, cached by moduli (the C entry's callers
// use a handful of profiles)
static const InvTables& inv_tables(const RnsTables& t) {
  static struct { int K, moduli[RNS_MAX_K]; InvTables v; } cache[16];
  static int n = 0;
  for (int c = 0; c < n; ++c)
    if (cache[c].K == t.K &&
        !memcmp(cache[c].moduli, t.moduli, sizeof(int) * t.K))
      return cache[c].v;
  auto& e = cache[n < 16 ? n++ : 15];
  e.K = t.K;
  memcpy(e.moduli, t.moduli, sizeof(int) * t.K);
  memset(&e.v, 0, sizeof(e.v));
  for (int i = 0; i < t.K; ++i)
    for (int j = i + 1; j < t.K; ++j)
      for (int x = 1; x < t.moduli[j]; ++x)
        if (t.moduli[i] * x % t.moduli[j] == 1) {
          e.v.inv[i * RNS_MAX_K + j] = x;
          break;
        }
  return e.v;
}

template <int K>
__device__ __forceinline__ void mrc_digits_two_pass(const int (&r_in)[K],
                                                    int (&d)[K],
                                                    const RnsTables& t,
                                                    const InvTables& iv) {
  int r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = r_in[j];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    d[i] = r[i];
#pragma unroll
    for (int j = i + 1; j < K; ++j) {
      const int v = (r[j] - d[i]) * iv.inv[i * RNS_MAX_K + j];
      r[j] = MULHI ? mulhi_mod(v + t.moff[j], t.moduli[j], t.magic[j])
                   : floor_mod(v, t.moduli[j]);
    }
  }
}

template <int K>
__device__ __forceinline__ float mrc_decode_two_pass(int (&r)[K],
                                                     const RnsTables& t,
                                                     const InvTables& iv) {
  int d[K];
  mrc_digits_two_pass<K>(r, d, t, iv);
  bool ge = false, eq = true;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    ge = ge || (eq && d[j] > t.half[j]);
    eq = eq && d[j] == t.half[j];
  }
  const bool neg = ge || eq;
  if constexpr (PASSES == 1) {
    int carry = 1;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      int g = t.moduli[j] - 1 - d[j] + carry;
      carry = g == t.moduli[j];
      d[j] = neg ? (carry ? 0 : g) : d[j];
    }
  } else {
    if (neg) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        r[j] = MULHI ? (r[j] ? t.moduli[j] - r[j] : 0)
                     : floor_mod(t.moduli[j] - r[j], t.moduli[j]);
    }
    mrc_digits_two_pass<K>(r, d, t, iv);
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    acc = __fadd_rn(acc, __fmul_rn((float)d[j], t.w[j]));
  return neg ? -acc : acc;
}

template <int K>
__global__ void rns_normalize_kernel(const int32_t* __restrict__ res,
                                     long long T,
                                     const __grid_constant__ RnsTables t,
                                     const __grid_constant__ InvTables iv,
                                     float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  int r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = res[(long long)j * T + i];
  out[i] = mrc_decode_two_pass<K>(r, t, iv);
}

template <int K>
static void launch(const int32_t* res, long long T, const RnsTables& t,
                   float* out, int threads, cudaStream_t st) {
  const unsigned blocks = (unsigned)((T + threads - 1) / threads);
  rns_normalize_kernel<K><<<blocks, threads, 0, st>>>(res, T, t,
                                                   inv_tables(t), out);
}

extern "C" int rns_normalize(const void* res, long long T, const RnsTables* t,
                             void* out, int threads, void* stream) {
  const int32_t* r = (const int32_t*)res;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (t->K) {
    case 5: launch<5>(r, T, *t, o, threads, st); break;
    case 6: launch<6>(r, T, *t, o, threads, st); break;
    case 7: launch<7>(r, T, *t, o, threads, st); break;
    case 8: launch<8>(r, T, *t, o, threads, st); break;
    case 9: launch<9>(r, T, *t, o, threads, st); break;
    case 12: launch<12>(r, T, *t, o, threads, st); break;
    case 16: launch<16>(r, T, *t, o, threads, st); break;
    case 18: launch<18>(r, T, *t, o, threads, st); break;
    case 21: launch<21>(r, T, *t, o, threads, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
