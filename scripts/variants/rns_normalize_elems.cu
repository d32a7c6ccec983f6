// Design candidate, built only by scripts/kernel_variants.py (study
// normalize_design): the one-pass MRC normalization of
// src/repro_torch/kernels/rns_normalize/csrc/rns_normalize.cu with ELEMS
// (2 or 4) consecutive elements a thread, kept to be measured beside the
// shipped one element a thread.  Every load first, one ELEMS-wide vector
// (int2, int4) a digit plane, then one float2 (float4) store.  The vector
// path needs T % ELEMS == 0 (plane j starts at j * T * 4 bytes) and
// 4 * ELEMS-byte aligned pointers; otherwise element by element, the last
// run's tail masked.  Same C entry as the shipped kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_mrc.cuh"

// elements a thread (2 or 4): the vector width of its loads and store
constexpr int ELEMS = 2;

__device__ __forceinline__ void unpack(int v, int (&o)[1]) { o[0] = v; }
__device__ __forceinline__ void unpack(int2 v, int (&o)[2]) {
  o[0] = v.x, o[1] = v.y;
}
__device__ __forceinline__ void unpack(int4 v, int (&o)[4]) {
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void store(float* p, const float (&f)[1]) {
  *p = f[0];
}
__device__ __forceinline__ void store(float* p, const float (&f)[2]) {
  *(float2*)p = make_float2(f[0], f[1]);
}
__device__ __forceinline__ void store(float* p, const float (&f)[4]) {
  *(float4*)p = make_float4(f[0], f[1], f[2], f[3]);
}
template <int E> struct IntVec;
template <> struct IntVec<1> { using type = int; };
template <> struct IntVec<2> { using type = int2; };
template <> struct IntVec<4> { using type = int4; };

template <int K, bool VEC>
__global__ void rns_normalize_kernel(const int32_t* __restrict__ res,
                                     long long T,
                                     const __grid_constant__ RnsTables t,
                                     float* __restrict__ out) {
  const long long i0 =
      ELEMS * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i0 >= T) return;
  int r[ELEMS][K];
  const int32_t* p = res + i0;
#pragma unroll
  for (int j = 0; j < K; ++j, p += T) {
    int v[ELEMS];
    if constexpr (VEC) {
      unpack(*(const typename IntVec<ELEMS>::type*)p, v);
    } else {
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) v[e] = i0 + e < T ? p[e] : 0;
    }
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) r[e][j] = v[e];
  }
  float f[ELEMS];
#pragma unroll
  for (int e = 0; e < ELEMS; ++e) f[e] = mrc_decode_float<K>(r[e], t);
  if constexpr (VEC) {
    store(out + i0, f);
  } else {
#pragma unroll
    for (int e = 0; e < ELEMS; ++e)
      if (i0 + e < T) out[i0 + e] = f[e];
  }
}

template <int K>
static void launch(const int32_t* res, long long T, const RnsTables& t,
                   float* out, int threads, cudaStream_t st) {
  const long long runs = (T + ELEMS - 1) / ELEMS;
  const unsigned blocks = (unsigned)((runs + threads - 1) / threads);
  const unsigned align = 4 * ELEMS;
  if (T % ELEMS == 0 && (uintptr_t)res % align == 0 &&
      (uintptr_t)out % align == 0)
    rns_normalize_kernel<K, true><<<blocks, threads, 0, st>>>(res, T, t, out);
  else
    rns_normalize_kernel<K, false><<<blocks, threads, 0, st>>>(res, T, t,
                                                               out);
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
