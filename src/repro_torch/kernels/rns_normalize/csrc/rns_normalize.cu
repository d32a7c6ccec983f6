// MRC normalization: [K, T] int32 residues -> [T] float32 signed values,
// one thread per element, the K digits in registers (K is a template
// parameter so the digit loops unroll).  Steps, as core/mrc.decode_float:
// MRC digits; sign = digits >= those of M/2 (lexicographic, most
// significant last); magnitude = (m - r) mod m for negatives; MRC of the
// magnitude; sum_j d_j * float32(W_j) digit-ascending with __fmul_rn /
// __fadd_rn, so nvcc cannot contract the sum into FMAs (an FMA changes the
// last bit, ROADMAP C.1); negate.  Replaces the Pallas kernel
// src/repro/kernels/rns_normalize/kernel.py:rns_normalize_tiles; see
// kernels/rns_normalize/ops.py for its bound and design.
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int K>
__global__ void rns_normalize_kernel(const int32_t* __restrict__ res,
                                     long long T,
                                     const __grid_constant__ RnsTables t,
                                     float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  int r[K], d[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = res[(long long)j * T + i];
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
  out[i] = neg ? -acc : acc;
}

template <int K>
static void launch(const int32_t* res, long long T, const RnsTables& t,
                   float* out, cudaStream_t st) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((T + threads - 1) / threads);
  rns_normalize_kernel<K><<<blocks, threads, 0, st>>>(res, T, t, out);
}

// res [K, T] int32, out [T] float32.  K must be a profile's digit count.
extern "C" int rns_normalize(const void* res, long long T, const RnsTables* t,
                             void* out, void* stream) {
  const int32_t* r = (const int32_t*)res;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (t->K) {
    case 5: launch<5>(r, T, *t, o, st); break;
    case 6: launch<6>(r, T, *t, o, st); break;
    case 7: launch<7>(r, T, *t, o, st); break;
    case 8: launch<8>(r, T, *t, o, st); break;
    case 9: launch<9>(r, T, *t, o, st); break;
    case 12: launch<12>(r, T, *t, o, st); break;
    case 16: launch<16>(r, T, *t, o, st); break;
    case 18: launch<18>(r, T, *t, o, st); break;
    case 21: launch<21>(r, T, *t, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
