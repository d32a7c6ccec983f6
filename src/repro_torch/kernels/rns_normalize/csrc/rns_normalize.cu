// MRC normalization: [K, T] int32 residues -> [T] float32 signed values,
// one thread per element, the K digits in registers; the per-element
// steps live in csrc/rns_mrc.cuh (shared with the fused kernels).
// Replaces the Pallas kernel
// src/repro/kernels/rns_normalize/kernel.py:rns_normalize_tiles; see
// kernels/rns_normalize/ops.py for its bound and design.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_mrc.cuh"

template <int K>
__global__ void rns_normalize_kernel(const int32_t* __restrict__ res,
                                     long long T,
                                     const __grid_constant__ RnsTables t,
                                     float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  int r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = res[(long long)j * T + i];
  out[i] = mrc_decode_float<K>(r, t);
}

template <int K>
static void launch(const int32_t* res, long long T, const RnsTables& t,
                   float* out, int threads, cudaStream_t st) {
  const unsigned blocks = (unsigned)((T + threads - 1) / threads);
  rns_normalize_kernel<K><<<blocks, threads, 0, st>>>(res, T, t, out);
}

// res [K, T] int32, out [T] float32.  K must be a profile's digit count;
// `threads` per block is the tile bt (registers cap it for wide K:
// analysis/kernel_audit.py).
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
