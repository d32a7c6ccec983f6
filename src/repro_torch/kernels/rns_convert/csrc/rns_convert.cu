// Forward conversion: float32 -> residue digit planes, one thread per
// element.  v = clip(rint(x * s), -qmax, qmax) (csrc/rns_quantize.cuh),
// then residue_j = v mod m_j (floor-mod).  Replaces the Pallas kernel
// src/repro/kernels/rns_convert/kernel.py:rns_convert_tiles; see
// kernels/rns_convert/ops.py for its bound and design.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_quantize.cuh"
#include "rns_tables.cuh"

template <typename OutT>
__global__ void rns_convert_kernel(const float* __restrict__ x,
                                   const float* __restrict__ s,
                                   long long group, long long T, float qmax,
                                   const __grid_constant__ RnsTables t,
                                   OutT* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int q = quantize_rn(x[i], s[i / group], qmax);
  for (int j = 0; j < t.K; ++j) {
    out[(long long)j * T + i] = (OutT)floor_mod(q, t.moduli[j]);
  }
}

// x [T] float32, s [T / group] float32 (one scale per run of `group`
// consecutive elements), out [K, T] int8 (out_int8) or int32; `threads`
// per block (the tile bt, a multiple of 32 up to 1024).
extern "C" int rns_convert(const void* x, const void* s, long long group,
                           long long T, float qmax, const RnsTables* t,
                           void* out, int out_int8, int threads,
                           void* stream) {
  const unsigned blocks = (unsigned)((T + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_int8) {
    rns_convert_kernel<int8_t><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)s, group, T, qmax, *t, (int8_t*)out);
  } else {
    rns_convert_kernel<int32_t><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)s, group, T, qmax, *t, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
