// Online-softmax attention (inference forward) on the tensor cores,
// causal top-left or not, GQA by indexing: q [B, Tq, H, D],
// k [B, Tk, Hk, D], v [B, Tk, Hk, Dv] -> o [B, Tq, H, Dv] in q's type.
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhtd; see
// kernels/flash_attention/ops.py for its bound and design.
//
// FlashAttention-2 layout.  A block of bq / 16 warps owns bq query rows
// of one (batch, head); each warp owns 16 rows, its q fragments held in
// registers for the whole KV loop.  Tiles of BK keys of K and V (KV head
// h / (H / Hk), read in place) come through a 2-stage cp.async ring in
// dynamic shared memory, D and Dv padded with zeros to DP (a power of
// two >= 16).  Scores stay in the MMA accumulators: the softmax runs on
// them, each row's max and sum reduced over the 4 lanes of a quad, and
// the probabilities feed the P.V product from the same registers.
//
// Products, by type (one template, two MMA policies):
//  * bf16 / fp16: mma.sync.m16n8k16 with float32 accumulation.  Q.K^T of
//    16-bit inputs has exact products.  P is float32: rounded once to
//    16 bits it would miss the 2e-5 bar, so P = p_hi + p_lo, both in the
//    input type, and P.V is two MMAs.  V fragments come through
//    ldmatrix.trans.
//  * float32: 3xTF32 on mma.sync.m16n8k8.tf32: every operand x is split
//    into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and each product
//    is lo.hi + hi.lo + hi.hi, accurate to about float32 for three TF32
//    MMAs.  P.V's k index is permuted (k' = t -> key 2t, t + 4 -> key
//    2t + 1) so that the score accumulators are the A registers as they
//    stand.
//
// The update keeps the Pallas kernel's order (kernel.py:55-61):
//   s = (q.k) * scale, masked to -1e30; m_new = max(m, rowmax(s));
//   p = exp(s - m_new); corr = exp(m - m_new); l = l * corr + sum(p);
//   acc = acc * corr + p.v;   o = acc / max(l, 1e-30)
// with expf (not __expf) and no fast-math.  Keys past Tk score -1e30
// (the TPU kernel's tk_valid); query rows past Tq are not written.
// Causal: a warp skips KV tiles wholly above its last row (each row has
// already seen key 0, so such a tile would add p = 0 and multiply by
// corr = 1), and the block stops at its own last row.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int MAX_THREADS = 256;    // bq <= 128
constexpr int DMAX = 128;           // widest head (D and Dv) the kernel takes
constexpr float NEG_INF = -1e30f;

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
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// two floats -> (lo16 = x0, hi16 = x1) in T, round to nearest even
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *(const uint32_t*)&h;
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *(const uint32_t*)&h;
  }
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = *(const __nv_bfloat162*)&w;
    return make_float2(__low2float(h), __high2float(h));
  } else {
    const __half2 h = *(const __half2*)&w;
    return make_float2(__low2float(h), __high2float(h));
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo with hi, lo in TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int DP>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // row stride in elements: 16-byte aligned rows, conflict-free
  // fragment loads (f32: 4 words of pad; 16-bit: 16 bytes of pad)
  static constexpr int KS = DP + (F32 ? 4 : 8);
};

// Stage keys [k0, k0 + BK) of K and V into one ring slot; keys past Tk
// are zero.  Columns past D (Dv) are never written: zeroed once.
template <typename T, int BK, int DP>
__device__ __forceinline__ void stage(T* Ks, T* Vs, const T* __restrict__ Kp,
                                      const T* __restrict__ Vp, int k0,
                                      int Tk, int D, int Dv, long long kvrow,
                                      long long vrow, bool vec) {
  constexpr int KS = Layout<T, DP>::KS, E = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int cd = D / E, cv = Dv / E;
    for (int c = tid; c < BK * cd; c += nt) {
      const int r = c / cd, ch = c % cd;
      const bool ok = k0 + r < Tk;
      cp_async16(Ks + r * KS + ch * E,
                 ok ? (const void*)(Kp + (k0 + r) * kvrow + ch * E) : Kp,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < BK * cv; c += nt) {
      const int r = c / cv, ch = c % cv;
      const bool ok = k0 + r < Tk;
      cp_async16(Vs + r * KS + ch * E,
                 ok ? (const void*)(Vp + (k0 + r) * vrow + ch * E) : Vp,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BK * D; e += nt) {
      const int r = e / D, d = e % D;
      Ks[r * KS + d] = k0 + r < Tk ? Kp[(k0 + r) * kvrow + d] : T(0.f);
    }
    for (int e = tid; e < BK * Dv; e += nt) {
      const int r = e / Dv, d = e % Dv;
      Vs[r * KS + d] = k0 + r < Tk ? Vp[(k0 + r) * vrow + d] : T(0.f);
    }
  }
}

template <typename T, int BK, int DP>
__global__ void __launch_bounds__(MAX_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Tq,
                       int Tk, int H, int Hk, int D, int Dv, int causal,
                       float scale, int vec) {
  using L = Layout<T, DP>;
  constexpr bool F32 = L::F32;
  constexpr int KS = L::KS, NJ = BK / 8, NV = DP / 8;
  constexpr int QK = F32 ? DP / 8 : DP / 16;      // k steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = (T*)smem_raw;
  constexpr int TILE = BK * KS;                   // one K (or V) slot

  const int warps = blockDim.x / 32, bq = 16 * warps;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;   // longest rows first
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * w + g, r1 = r0 + 8;      // this thread's rows
  const long long qrow = (long long)H * D, kvrow = (long long)Hk * D,
                  vrow = (long long)Hk * Dv;
  const T* Q = q + ((long long)b * Tq * H + h) * D;
  const T* Kp = k + ((long long)b * Tk * Hk + hk) * D;
  const T* Vp = v + ((long long)b * Tk * Hk + hk) * Dv;

  for (int e = threadIdx.x; e < 4 * TILE; e += blockDim.x) smem[e] = T(0.f);
  __syncthreads();                  // pads stay zero; staging follows

  // q fragments (zero past D and past Tq)
  auto qv = [&](int r, int d) -> float {
    return (r < Tq && d < D) ? to_f(Q[r * qrow + d]) : 0.f;
  };
  float qf[F32 ? QK : 1][4];        // float32: raw, split per use
  uint32_t qa[F32 ? 1 : QK][4];     // 16-bit: packed pairs
#pragma unroll
  for (int kk = 0; kk < QK; ++kk) {
    if constexpr (F32) {
      qf[kk][0] = qv(r0, 8 * kk + t);
      qf[kk][1] = qv(r1, 8 * kk + t);
      qf[kk][2] = qv(r0, 8 * kk + t + 4);
      qf[kk][3] = qv(r1, 8 * kk + t + 4);
    } else {
      const int d = 16 * kk + 2 * t;
      qa[kk][0] = pack2<T>(qv(r0, d), qv(r0, d + 1));
      qa[kk][1] = pack2<T>(qv(r1, d), qv(r1, d + 1));
      qa[kk][2] = pack2<T>(qv(r0, d + 8), qv(r0, d + 9));
      qa[kk][3] = pack2<T>(qv(r1, d + 8), qv(r1, d + 9));
    }
  }

  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int kend = causal ? min(Tk, q0 + bq) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  const int wlast = q0 + 16 * w + 15;               // the warp's last row
  const bool wlive = q0 + 16 * w < Tq;

  if (ntiles > 0)
    stage<T, BK, DP>(smem, smem + TILE, Kp, Vp, 0, Tk, D, Dv, kvrow, vrow,
                     vec);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < ntiles) {
      T* slot = smem + ((it + 1) & 1) * 2 * TILE;
      stage<T, BK, DP>(slot, slot + TILE, Kp, Vp, k0 + BK, Tk, D, Dv, kvrow,
                       vrow, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = smem + (it & 1) * 2 * TILE;
    const T* Vs = Ks + TILE;

    if (wlive && !(causal && k0 > wlast)) {
      // ---- scores s = q.k^T for this warp's 16 rows x BK keys
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < QK; ++kk) {
        if constexpr (F32) {
          if (8 * kk >= D) break;
          uint32_t qh[4], ql[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(qf[kk][e], qh[e], ql[e]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float* kr = Ks + (8 * j + g) * KS + 8 * kk + t;
            uint32_t kh0, kl0, kh1, kl1;
            split_tf32(kr[0], kh0, kl0);
            split_tf32(kr[4], kh1, kl1);
            mma_tf32(s[j], ql, kh0, kh1);
            mma_tf32(s[j], qh, kl0, kl1);
            mma_tf32(s[j], qh, kh0, kh1);
          }
        } else {
          if (16 * kk >= D) break;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const T* kr = Ks + (8 * j + g) * KS + 16 * kk + 2 * t;
            mma_16<T>(s[j], qa[kk], *(const uint32_t*)kr,
                      *(const uint32_t*)(kr + 8));
          }
        }
      }
      // ---- scale, mask, online softmax on the accumulators
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1, key = k0 + 8 * j + 2 * t + (e & 1);
          float x = s[j][e] * scale;
          if (key >= Tk || (causal && row < key)) x = NEG_INF;
          s[j][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m[e / 2]);
          s[j][e] = p;
          ps[e / 2] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
        l[i] = l[i] * corr[i] + ps[i];
      }
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e / 2];

      // ---- acc += p.v
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          // A rows g / g + 8, k' = t -> key 2t, k' = t + 4 -> key 2t + 1
          uint32_t ph[4], pl[4];
          split_tf32(s[kk][0], ph[0], pl[0]);
          split_tf32(s[kk][2], ph[1], pl[1]);
          split_tf32(s[kk][1], ph[2], pl[2]);
          split_tf32(s[kk][3], ph[3], pl[3]);
          const float* v0 = Vs + (8 * kk + 2 * t) * KS + g;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            if (8 * j >= Dv) break;
            uint32_t vh0, vl0, vh1, vl1;
            split_tf32(v0[8 * j], vh0, vl0);
            split_tf32(v0[KS + 8 * j], vh1, vl1);
            mma_tf32(acc[j], pl, vh0, vh1);
            mma_tf32(acc[j], ph, vl0, vl1);
            mma_tf32(acc[j], ph, vh0, vh1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // a0: tile 2kk rows g; a1: 2kk rows g+8; a2, a3: tile 2kk+1
            const float x0 = s[2 * kk + i / 2][2 * (i % 2)];
            const float x1 = s[2 * kk + i / 2][2 * (i % 2) + 1];
            ph[i] = pack2<T>(x0, x1);
            const float2 hi = unpack2<T>(ph[i]);
            pl[i] = pack2<T>(x0 - hi.x, x1 - hi.y);
          }
          // matrix i of the x4: keys 16kk + 8 (i & 1) + row, columns
          // 8 (j + i / 2): B registers of n8 tiles j and j + 1
          const int mi = lane / 8, mr = lane % 8;
          const T* vrow0 = Vs + (16 * kk + 8 * (mi & 1) + mr) * KS +
                           8 * (mi / 2);
#pragma unroll
          for (int j = 0; j < NV; j += 2) {
            if (8 * j >= Dv) break;
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vrow0 + 8 * j);
            mma_16<T>(acc[j], pl, vb[0], vb[1]);
            mma_16<T>(acc[j], ph, vb[0], vb[1]);
            mma_16<T>(acc[j + 1], pl, vb[2], vb[3]);
            mma_16<T>(acc[j + 1], ph, vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();                // slot it & 1 is free for tile it + 2
  }
  cp_async_wait<0>();

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1, col = 8 * j + 2 * t + (e & 1);
      if (row < Tq && col < Dv)
        o[(((long long)b * Tq + row) * H + h) * Dv + col] =
            from_f<T>(acc[j][e] / den[e / 2]);
    }
}

template <typename T, int DP>
static size_t smem_bytes(int bk) {
  return sizeof(T) * 2 * 2 * (size_t)bk * Layout<T, DP>::KS;
}

template <typename T, int BK, int DP>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Tq, int Tk, int H, int Hk, int D, int Dv,
                  int bq, int causal, float scale, cudaStream_t st) {
  const size_t shmem = smem_bytes<T, DP>(BK);
  auto kern = flash_attention_kernel<T, BK, DP>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int E = 16 / sizeof(T);
  const int vec = D % E == 0 && Dv % E == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid(B * H, (Tq + bq - 1) / bq);
  kern<<<grid, 2 * bq, shmem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                    (T*)o, Tq, Tk, H, Hk, D, Dv, causal,
                                    scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
static int launch_bk(const void* q, const void* k, const void* v, void* o,
                     int B, int Tq, int Tk, int H, int Hk, int D, int Dv,
                     int bq, int bk, int causal, float scale,
                     cudaStream_t st) {
  switch (bk) {
    case 32: return launch<T, 32, DP>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv,
                                      bq, causal, scale, st);
    case 64: return launch<T, 64, DP>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv,
                                      bq, causal, scale, st);
    case 128: return launch<T, 128, DP>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv,
                                        bq, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_dp(const void* q, const void* k, const void* v, void* o,
                     int B, int Tq, int Tk, int H, int Hk, int D, int Dv,
                     int bq, int bk, int causal, float scale,
                     cudaStream_t st) {
  const int d = D > Dv ? D : Dv;
  if (d <= 16) return launch_bk<T, 16>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv,
                                       bq, bk, causal, scale, st);
  if (d <= 32) return launch_bk<T, 32>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv,
                                       bq, bk, causal, scale, st);
  if (d <= 64) return launch_bk<T, 64>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv,
                                       bq, bk, causal, scale, st);
  return launch_bk<T, 128>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bq, bk,
                           causal, scale, st);
}

// q [B, Tq, H, D], k [B, Tk, Hk, D], v [B, Tk, Hk, Dv], o [B, Tq, H, Dv],
// all contiguous, of one type: dtype 0 float32, 1 bfloat16, 2 float16.
// H % Hk == 0, D and Dv <= 128, bq in {32, 64, 128} (2 bq threads),
// bk in {32, 64, 128}.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Tq, int Tk,
                               int H, int Hk, int D, int Dv, int bq, int bk,
                               int causal, float scale, void* stream) {
  if (Hk <= 0 || H % Hk || D > DMAX || Dv > DMAX || D <= 0 || Dv <= 0 ||
      (bq != 32 && bq != 64 && bq != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_dp<float>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bq,
                                    bk, causal, scale, st);
    case 1: return launch_dp<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, Hk, D,
                                            Dv, bq, bk, causal, scale, st);
    case 2: return launch_dp<__half>(q, k, v, o, B, Tq, Tk, H, Hk, D, Dv, bq,
                                     bk, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
