// Online-softmax attention (inference forward), causal top-left or not,
// GQA by indexing: q [B, Tq, H, D], k [B, Tk, Hk, D], v [B, Tk, Hk, Dv]
// -> o [B, Tq, H, Dv] in q's type, float32 arithmetic throughout.
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhtd; see
// kernels/flash_attention/ops.py for its bound and design.
//
// One block of 256 threads per (b * H + h, BQ query rows).  The q tile is
// staged once in shared memory as float32; K and V tiles of `bk` rows are
// staged in turn (dynamic shared memory, opted in above 48 KiB), read from
// KV head h / (H / Hk) in place: no repeated copy of the KV heads.  TPR =
// 256 / BQ consecutive threads own one query row: its running max m, sum l
// and its share of the accumulator (columns sub, sub + TPR, ...) stay in
// registers; its scores of the current tile go through shared memory.  The
// update keeps the Pallas kernel's order (kernel.py:55-61):
//   m_new = max(m, rowmax(s)); p = exp(s - m_new); corr = exp(m - m_new);
//   l = l * corr + sum(p); acc = acc * corr + p @ v;   o = acc / max(l, 1e-30)
// with expf (not __expf) and no fast-math.  Tails on both axes are masked
// here (keys past Tk score -1e30, as the TPU kernel's tk_valid does; query
// rows past Tq are not written).  Causal: KV tiles wholly above the
// diagonal of the block's last row are skipped -- each row has already
// seen key 0, so such a tile would add p = 0 and multiply by corr = 1.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int DMAX = 128;           // widest head (D and Dv) the kernel takes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);   // round to nearest even, as .to(bf16)
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <int TPR>
__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int TPR>
__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Tq,
                       int Tk, int H, int Hk, int D, int Dv, int bk,
                       int causal, float scale) {
  constexpr int TPR = THREADS / BQ;         // threads per query row
  constexpr int NACC = DMAX / TPR;          // accumulator columns a thread
  extern __shared__ float smem[];
  const int Dp = D + 1, Sp = bk + 1;        // +1: no bank conflicts
  float* Qs = smem;                         // [BQ][D + 1]
  float* Ks = Qs + BQ * Dp;                 // [bk][D + 1]
  float* Vs = Ks + bk * Dp;                 // [bk][Dv]
  float* Ss = Vs + bk * Dv;                 // [BQ][bk + 1]

  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, r = tid / TPR, sub = tid % TPR;
  const int qi = q0 + r;
  const long long qrow = (long long)H * D, kvrow = (long long)Hk * D,
                  vrow = (long long)Hk * Dv;
  const T* Q = q + ((long long)b * Tq * H + h) * D;
  const T* Kp = k + ((long long)b * Tk * Hk + hk) * D;
  const T* Vp = v + ((long long)b * Tk * Hk + hk) * Dv;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int rr = e / D, d = e % D;
    Qs[rr * Dp + d] = q0 + rr < Tq ? to_f(Q[(q0 + rr) * qrow + d]) : 0.f;
  }

  float m = NEG_INF, l = 0.f, acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float* Srow = Ss + r * Sp;
  const float* Qrow = Qs + r * Dp;
  const int kend = causal ? min(Tk, q0 + BQ) : Tk;

  for (int k0 = 0; k0 < kend; k0 += bk) {
    const int nk = min(bk, Tk - k0);        // keys of this tile
    __syncthreads();                        // the last tile is consumed
    for (int e = tid; e < bk * D; e += THREADS) {
      const int c = e / D, d = e % D;
      Ks[c * Dp + d] = c < nk ? to_f(Kp[(k0 + c) * kvrow + d]) : 0.f;
    }
    for (int e = tid; e < bk * Dv; e += THREADS) {
      const int c = e / Dv, d = e % Dv;
      Vs[c * Dv + d] = c < nk ? to_f(Vp[(k0 + c) * vrow + d]) : 0.f;
    }
    __syncthreads();
    // scores of this thread's keys c = sub, sub + TPR, ...; rowmax
    float mx = NEG_INF;
    for (int c = sub; c < bk; c += TPR) {
      const float* Kr = Ks + c * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qrow[d], Kr[d], s);
      s *= scale;
      const int kc = k0 + c;
      if (c >= nk || (causal && qi < kc)) s = NEG_INF;
      Srow[c] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, row_reduce_max<TPR>(mx));
    float ps = 0.f;
    for (int c = sub; c < bk; c += TPR) {
      const float p = expf(Srow[c] - m_new);
      Srow[c] = p;
      ps += p;
    }
    const float corr = expf(m - m_new);
    l = l * corr + row_reduce_sum<TPR>(ps);
    m = m_new;
    __syncwarp();                           // the row's p are all written
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int j = sub + TPR * i;
      if (j < Dv) {
        float pv = 0.f;
        for (int c = 0; c < nk; ++c) pv = fmaf(Srow[c], Vs[c * Dv + j], pv);
        acc[i] = acc[i] * corr + pv;
      }
    }
  }
  if (qi >= Tq) return;
  T* O = o + (((long long)b * Tq + qi) * H + h) * Dv;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int j = sub + TPR * i;
    if (j < Dv) O[j] = from_f<T>(acc[i] / den);
  }
}

template <typename T, int BQ>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Tq, int Tk, int H, int Hk, int D, int Dv,
                  int bk, int causal, float scale, cudaStream_t st) {
  const size_t shmem = sizeof(float) * ((size_t)BQ * (D + 1) +
                                        (size_t)bk * (D + 1) +
                                        (size_t)bk * Dv +
                                        (size_t)BQ * (bk + 1));
  auto kern = flash_attention_kernel<T, BQ>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, THREADS, shmem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                     (T*)o, Tq, Tk, H, Hk, D, Dv, bk,
                                     causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bq(const void* q, const void* k, const void* v, void* o,
                     int B, int Tq, int Tk, int H, int Hk, int D, int Dv,
                     int bq, int bk, int causal, float scale,
                     cudaStream_t st) {
  switch (bq) {
    case 32: return launch<T, 32>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bk,
                                  causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bk,
                                  causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bk,
                                    causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q [B, Tq, H, D], k [B, Tk, Hk, D], v [B, Tk, Hk, Dv], o [B, Tq, H, Dv],
// all contiguous, of one type: dtype 0 float32, 1 bfloat16, 2 float16.
// H % Hk == 0, D and Dv <= 128, bq in {32, 64, 128}, bk >= 1.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Tq, int Tk,
                               int H, int Hk, int D, int Dv, int bq, int bk,
                               int causal, float scale, void* stream) {
  if (Hk <= 0 || H % Hk || D > DMAX || Dv > DMAX || D <= 0 || Dv <= 0 ||
      bk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_bq<float>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bq,
                                    bk, causal, scale, st);
    case 1: return launch_bq<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, Hk, D,
                                            Dv, bq, bk, causal, scale, st);
    case 2: return launch_bq<__half>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bq,
                                     bk, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
