// MRC normalization: [K, T] int32 residues -> [T] float32 signed values.
// Replaces the Pallas kernel
// src/repro/kernels/rns_normalize/kernel.py:rns_normalize_tiles; see
// kernels/rns_normalize/ops.py for its bound and design.
//
// * Input contract: every residue res[j, i] lies in [0, m_j), as every
//   producer in the port leaves it (core/rns.py's floor-mods, rns_matmul's
//   reduced sums).
// * One element a thread, its K digits in registers: a block's threads
//   take consecutive elements, so each of a warp's K plane loads
//   coalesces.  The MRC is a long dependent chain, and 2 or 4 elements a
//   thread leave too few warps to hide it (scripts/kernel_variants.py
//   normalize_design, scripts/variants/rns_normalize_elems.cu).
// * Each element: one MRC pass of multiply-high terms, the sign, and the
//   magnitude's digits from the same pass (csrc/rns_mrc.cuh, shared with
//   the fused kernels' epilogue): no division on the path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_mrc.cuh"

template <int K>
__global__ void rns_normalize_kernel(const int32_t* __restrict__ res,
                                     long long T,
                                     const __grid_constant__ RnsTables t,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
// `threads` per block is the tile bt (every candidate fits every K:
// analysis/kernel_audit.py REGISTERS).
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
