// Forward conversion: float32 -> residue digit planes.
// v = clip(rint(x * s), -qmax, qmax) (csrc/rns_quantize.cuh), then
// residue_j = v mod m_j (floor-mod).  Replaces the Pallas kernel
// src/repro/kernels/rns_convert/kernel.py:rns_convert_tiles; see
// kernels/rns_convert/ops.py for its bound and design.
//
// * A thread converts QUADS runs of 4 consecutive elements (its loads
//   issued first): one float4 load a run where x is 16-byte aligned and
//   T % 4 == 0, else element by element, the last run's tail masked.
// * The scale: one load when it is a scalar (group >= T); otherwise one
//   32-bit division finds the run of the thread's first element, and a
//   counter steps the other three along the runs.
// * K is a template parameter (one instantiation per profile digit
//   count), so the digit loop unrolls; each residue is quant_residue's
//   offset multiply-high mod while qmax <= 65535 (bits <= 17), and
//   floor_mod's division for wider values.
// * Stores: one 32-bit word of 4 int8 residues per digit plane (an int4
//   for int32 residues) when T % 4 == 0, so a warp writes 512 (2048)
//   contiguous bytes of each plane; else element by element.
// * Indices are 32-bit: T must be below 2^31 - 2^16 (the entry refuses
//   more), so no thread's index passes 2^31; the digit planes are
//   reached by pointer steps of T.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rns_quantize.cuh"
#include "rns_tables.cuh"

template <bool NARROW, int K, typename OutT>
__device__ __forceinline__ void store_digits(const int (&v)[4], int n,
                                             bool whole, int T,
                                             const RnsTables& t,
                                             OutT* __restrict__ o) {
#pragma unroll
  for (int j = 0; j < K; ++j, o += T) {
    int r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = quant_residue<NARROW>(v[e], j, t);
    if (whole) {
      if constexpr (sizeof(OutT) == 1)
        *(uint32_t*)o = (uint32_t)(r[0] | r[1] << 8 | r[2] << 16 |
                                   r[3] << 24);
      else
        *(int4*)o = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) o[e] = (OutT)r[e];
    }
  }
}

// quads of 4 elements a thread; a block's quad v is the v-th run of
// blockDim.x consecutive quads, so each of a warp's accesses coalesces
constexpr int QUADS = 1;

template <int K, typename OutT>
__global__ void rns_convert_kernel(const float* __restrict__ x,
                                   const float* __restrict__ s, int group,
                                   int T, float qmax, bool x_vec,
                                   const __grid_constant__ RnsTables t,
                                   OutT* __restrict__ out) {
  const int base = 4 * (blockIdx.x * blockDim.x * QUADS + threadIdx.x);
  const bool whole = (T & 3) == 0;  // then n == 4 and stores align
  float xv[QUADS][4], sv[QUADS][4];
#pragma unroll
  for (int u = 0; u < QUADS; ++u) {           // every load first
    const int i0 = base + 4 * u * blockDim.x;
    if (i0 >= T) break;
    const int n = min(4, T - i0);
    if (x_vec) {
      const float4 f = *(const float4*)(x + i0);
      xv[u][0] = f.x, xv[u][1] = f.y, xv[u][2] = f.z, xv[u][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[u][e] = e < n ? x[i0 + e] : 0.f;
    }
    if (group >= T) {
      const float f = s[0];
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[u][e] = f;
    } else {
      int q = i0 / group, r = i0 - q * group;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[u][e] = e < n ? s[q] : 0.f;
        if (++r == group) r = 0, ++q;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QUADS; ++u) {
    const int i0 = base + 4 * u * blockDim.x;
    if (i0 >= T) break;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = quantize_rn(xv[u][e], sv[u][e], qmax);
    if (qmax <= 65535.f)
      store_digits<true, K>(v, min(4, T - i0), whole, T, t, out + i0);
    else
      store_digits<false, K>(v, min(4, T - i0), whole, T, t, out + i0);
  }
}

template <int K, typename OutT>
static int launch(const float* x, const float* s, int group, int T,
                  float qmax, const RnsTables& t, OutT* out, int threads,
                  cudaStream_t st) {
  const bool x_vec = T % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int quads = (T + 3) / 4, per_block = threads * QUADS;
  const unsigned blocks = (unsigned)((quads + per_block - 1) / per_block);
  rns_convert_kernel<K, OutT><<<blocks, threads, 0, st>>>(
      x, s, group, T, qmax, x_vec, t, out);
  return (int)cudaGetLastError();
}

// Every profile's digit count (rns_normalize.cu's too), and the digit
// groups of digit sharding (1-4 digits a rank: rns9 over 3 ranks, rns8
// over 4, rns16 or rns8 over 8).
template <typename OutT>
static int launch_k(const float* x, const float* s, int group, int T,
                    float qmax, const RnsTables& t, OutT* out, int threads,
                    cudaStream_t st) {
#define RNS_CONVERT_CASE(k)                                                \
  case k:                                                                  \
    return launch<k, OutT>(x, s, group, T, qmax, t, out, threads, st);
  switch (t.K) {
    RNS_CONVERT_CASE(1) RNS_CONVERT_CASE(2) RNS_CONVERT_CASE(3)
    RNS_CONVERT_CASE(4) RNS_CONVERT_CASE(5) RNS_CONVERT_CASE(6)
    RNS_CONVERT_CASE(7) RNS_CONVERT_CASE(8) RNS_CONVERT_CASE(9)
    RNS_CONVERT_CASE(12) RNS_CONVERT_CASE(16) RNS_CONVERT_CASE(18)
    RNS_CONVERT_CASE(21)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNS_CONVERT_CASE
}

// x [T] float32, s [T / group] float32 (one scale per run of `group`
// consecutive elements), out [K, T] int8 (out_int8) or int32; `threads`
// per block (the tile bt, a multiple of 32 up to 1024), each thread
// QUADS x 4 elements.  T < 2^31 - 2^16.
extern "C" int rns_convert(const void* x, const void* s, long long group,
                           long long T, float qmax, const RnsTables* t,
                           void* out, int out_int8, int threads,
                           void* stream) {
  if (T < 0 || T > INT_MAX - 65536 || group < 1)
    return (int)cudaErrorInvalidValue;
  const int g = (int)(group < T ? group : T > 0 ? T : 1);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_int8)
    return launch_k((const float*)x, (const float*)s, g, (int)T, qmax, *t,
                    (int8_t*)out, threads, st);
  return launch_k((const float*)x, (const float*)s, g, (int)T, qmax, *t,
                  (int32_t*)out, threads, st);
}
