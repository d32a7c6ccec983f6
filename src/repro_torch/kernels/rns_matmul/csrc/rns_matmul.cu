// Digit-sliced modular matmul on the integer tensor cores:
// out[s] = (a[s] @ b[s]) mod m_s, a [S, M, D], b [S, D, N] residues in
// [0, m) with m <= 256, out int32.
// Replaces the Pallas kernel
// src/repro/kernels/rns_matmul/kernel.py:rns_matmul_tiles; see
// kernels/rns_matmul/ops.py for its bound and design.
//
// Products: mma.sync.m16n8k32.row.col.s32.u8.u8.s32.  Every residue of
// every profile is below 256, so unsigned bytes hold it: int8 residues
// (the int8-safe profiles, all in [0, 127]) are the same bytes read as
// u8, and int32 residues (rns8_u8) are narrowed to a byte while staged.
// A block owns a (BM rows, BN columns) tile of one digit and walks the
// 128-deep K steps of its share of D; BN / 32 warps each hold all BM rows
// of 32 columns, int32 accumulators in registers, reduced mod m after
// every `lim` = lazy_chunk - 1 terms (residues < m keep each product
// <= (m-1)^2, and lim * (m-1)^2 + m <= 2^31 - 1).
//
// Staging: a ring of STAGES shared-memory stages filled by 16-byte
// cp.async copies (int8 operands whose rows are 16-byte aligned), so the
// copies of the next K steps overlap the products of this one; other
// operands (int32 residues, ragged widths) are loaded and narrowed by the
// threads into the same ring.  A rows keep D contiguous, as the MMA's row
// operand wants; b is N-contiguous but the .col operand wants 4
// consecutive k of one column in a register: each thread reads a 4 x 4
// byte block (4 k rows, 4 columns) and transposes it with __byte_perm,
// which gives the B registers of 4 n8 tiles, the tile j holding columns
// 4g + j of the warp's 32 (g = lane / 4).
//
// Split over D: when the (digit, row tile, column tile) grid would leave
// SMs idle (decode: 8 rows), `splits` blocks share a tile's K steps.
// Each reduces its sum mod m and stores it in its own slice of the int32
// workspace `ws`; the last block of the tile to finish (a counter per
// tile, atomicAdd) adds the other slices' partial residues (read from L2)
// to its own and writes the total mod m.  Integer sums do not depend on
// their order, so the result is the same in every run; the last block
// sets the counter back to zero, and every slice is written before it is
// read, so the next launch (or a CUDA-graph replay) finds the workspace
// usable as it is: one launch per call, no memset.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_tables.cuh"

constexpr int BK = 128;             // K step: four k32 MMAs
constexpr int STAGES = 3;           // shared-memory ring
constexpr int PAD = 16;             // bytes after each staged row
constexpr int AST = BK + PAD;       // A row stride (bytes): 36 words,
                                    // conflict-free fragment loads

template <int BM, int BN>
struct Tile {
  static_assert(BM % 16 == 0 && BN % 32 == 0, "m16 rows, 32-column warps");
  static constexpr int THREADS = BN;          // one warp per 32 columns
  static constexpr int MI = BM / 16;          // m16 MMA rows per warp
  static constexpr int BST = BN + PAD;        // B row stride (bytes)
  static constexpr int STAGE = BM * AST + BK * BST;
  static constexpr int SMEM = STAGES * STAGE;
};

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

__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// w[i] holds bytes (row i, columns 0..3) -> w[j] holds (rows 0..3, col j)
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// Stage K step `k0` of A rows [row0, row0 + BM) and B columns
// [col0, col0 + BN) into one ring slot; out-of-range bytes are zero.
template <typename InT, int BM, int BN>
__device__ __forceinline__ void stage(uint8_t* sA, uint8_t* sB,
                                      const InT* __restrict__ A,
                                      const InT* __restrict__ B, int M,
                                      int N, int D, int row0, int col0,
                                      int k0, bool vec) {
  using L = Tile<BM, BN>;
  const int tid = threadIdx.x;
  if (sizeof(InT) == 1 && vec) {    // 16-byte cp.async, zero-filled tails
    for (int c = tid; c < BM * (BK / 16); c += L::THREADS) {
      const int r = c / (BK / 16), ch = c % (BK / 16);
      const int gm = row0 + r, gk = k0 + 16 * ch;
      const bool ok = gm < M && gk < D;
      cp_async16(sA + r * AST + 16 * ch,
                 ok ? (const void*)(A + (long long)gm * D + gk) : A,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < BK * (BN / 16); c += L::THREADS) {
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const int gk = k0 + r, gn = col0 + 16 * ch;
      const bool ok = gk < D && gn < N;
      cp_async16(sB + r * L::BST + 16 * ch,
                 ok ? (const void*)(B + (long long)gk * N + gn) : B,
                 ok ? 16 : 0);
    }
  } else {                          // element by element, narrowed to u8
    for (int e = tid; e < BM * BK; e += L::THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = row0 + r, gk = k0 + c;
      sA[r * AST + c] =
          (gm < M && gk < D) ? (uint8_t)A[(long long)gm * D + gk] : 0;
    }
    for (int e = tid; e < BK * BN; e += L::THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = col0 + c;
      sB[r * L::BST + c] =
          (gk < D && gn < N) ? (uint8_t)B[(long long)gk * N + gn] : 0;
    }
  }
}

template <typename InT, int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS)
rns_matmul_kernel(const InT* __restrict__ a, const InT* __restrict__ b,
                  int M, int N, int D, int lim, int per, int splits,
                  bool vec, const __grid_constant__ RnsTables t,
                  int32_t* __restrict__ out, int32_t* __restrict__ ws,
                  int32_t* __restrict__ cnt) {
  using L = Tile<BM, BN>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int s = blockIdx.z / splits, split = blockIdx.z % splits;
  const int m = t.moduli[s];
  const InT* A = a + (long long)s * M * D;
  const InT* B = b + (long long)s * D * N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int lane = threadIdx.x % 32, wn = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const int ksteps = (D + BK - 1) / BK;
  const int kb = split * per, n = min(ksteps, kb + per) - kb;

  // x mod m for 0 <= x < 2^31: a multiply-high with floor((2^32 - 1) / m)
  // and one correction (m <= 256)
  const uint32_t magic = 0xffffffffu / (uint32_t)m;
  auto mod = [&](int x) {
    const uint32_t q = __umulhi((uint32_t)x, magic);
    const int r = x - (int)q * m;
    return r >= m ? r - m : r;
  };

  int acc[L::MI][4][4];
#pragma unroll
  for (int i = 0; i < L::MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) {
      uint8_t* st = smem + i * L::STAGE;
      stage<InT, BM, BN>(st, st + BM * AST, A, B, M, N, D, row0, col0,
                         (kb + i) * BK, vec);
    }
    cp_async_commit();
  }
  int since = 0;                    // terms accumulated since a reduction
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();    // this thread's copies of step i
    __syncthreads();                // everyone's; slot i-1 is consumed
    if (i + STAGES - 1 < n) {
      uint8_t* st = smem + ((i + STAGES - 1) % STAGES) * L::STAGE;
      stage<InT, BM, BN>(st, st + BM * AST, A, B, M, N, D, row0, col0,
                         (kb + i + STAGES - 1) * BK, vec);
    }
    cp_async_commit();
    const uint8_t* sA = smem + (i % STAGES) * L::STAGE;
    const uint8_t* sB = sA + BM * AST;
#pragma unroll
    for (int kh = 0; kh < BK / 32; ++kh) {
      uint32_t b0[4], b1[4];        // rows 4tq + r (b0), 16 + 4tq + r (b1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint8_t* p = sB + (32 * kh + 4 * tq + r) * L::BST + 32 * wn +
                           4 * g;
        b0[r] = *(const uint32_t*)p;
        b1[r] = *(const uint32_t*)(p + 16 * L::BST);
      }
      transpose4x4(b0);
      transpose4x4(b1);
#pragma unroll
      for (int mi = 0; mi < L::MI; ++mi) {
        if (row0 + 16 * mi >= M) continue;    // warp-uniform: no rows
        const uint8_t* p = sA + (16 * mi + g) * AST + 32 * kh + 4 * tq;
        const uint32_t a0 = *(const uint32_t*)p;
        const uint32_t a1 = *(const uint32_t*)(p + 8 * AST);
        const uint32_t a2 = *(const uint32_t*)(p + 16);
        const uint32_t a3 = *(const uint32_t*)(p + 8 * AST + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_u8(acc[mi][j], a0, a1, a2, a3, b0[j], b1[j]);
      }
    }
    since += BK;
    if (since + BK > lim) {         // the next step could overflow int32
#pragma unroll
      for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = mod(acc[mi][j][e]);
      since = 0;
    }
  }
  cp_async_wait<0>();

  // fragment (mi, j, e) is row 16 mi + g + 8 (e / 2), column
  // 32 wn + 8 tq + 4 (e % 2) + j of the tile: each thread owns 8
  // consecutive columns of 2 MI rows.
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = mod(acc[mi][j][e]);

  int32_t* O = out + (long long)s * M * N;
  const int cbase = col0 + 32 * wn + 8 * tq;
  const bool vout = N % 4 == 0;     // 16-byte stores
  // write (or, with add, first add the other splits' slices to) the 2 MI
  // rows x 8 columns this thread owns into P (row stride N)
  auto emit = [&](int32_t* P, bool add) {
#pragma unroll
    for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 4; ++h) {           // (row half, column half)
        const int gm = row0 + 16 * mi + g + 8 * (h / 2);
        const int gn = cbase + 4 * (h % 2);
        if (gm >= M || gn >= N) continue;
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[mi][j][2 * (h / 2) + h % 2];
        if (add) {
          for (int sp = 0; sp < splits; ++sp) {
            if (sp == split) continue;
            const int32_t* W = ws + ((long long)s * splits + sp) * M * N +
                               (long long)gm * N + gn;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (gn + j < N) v[j] += __ldcg(W + j);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = mod(v[j]);
        }
        int32_t* dst = P + (long long)gm * N + gn;
        if (vout) {
          *(int4*)dst = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) dst[j] = v[j];
        }
      }
  };
  if (splits == 1) {
    emit(O, false);
    return;
  }
  emit(ws + (long long)blockIdx.z * M * N, false);   // this split's slice
  __threadfence();                  // the slice before the count
  __syncthreads();
  const int tile = (s * gridDim.y + blockIdx.y) *
                   gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(cnt + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  emit(O, true);
  if (threadIdx.x == 0) cnt[tile] = 0;
}

template <typename InT, int BM, int BN>
static int launch(const void* a, const void* b, int S, int M, int N, int D,
                  int lim, int splits, const RnsTables& t, void* out,
                  void* ws, void* cnt, cudaStream_t st) {
  using L = Tile<BM, BN>;
  const int ksteps = (D + BK - 1) / BK;
  if (splits < 1 || (splits > 1 && (ws == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  int per = (ksteps + splits - 1) / splits;
  if (per < 1) per = 1;
  splits = (ksteps + per - 1) / per;   // no split without K steps
  if (splits < 1) splits = 1;
  const bool vec = sizeof(InT) == 1 && D % 16 == 0 && N % 16 == 0 &&
                   (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  auto kern = rns_matmul_kernel<InT, BM, BN>;
  if (L::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S * splits);
  kern<<<grid, L::THREADS, L::SMEM, st>>>(
      (const InT*)a, (const InT*)b, M, N, D, lim, per, splits, vec, t,
      (int32_t*)out, (int32_t*)ws, (int32_t*)cnt);
  return (int)cudaGetLastError();
}

// a [S, M, D], b [S, D, N] residues (int8 if in_int8, else int32; all in
// [0, 256)), out [S, M, N] int32.  lim = lazy_chunk - 1 >= BK; (bm, bn)
// one of the compiled tiles.  splits > 1 shares each tile's K steps
// among that many blocks, and needs ws (int32, splits * S * M * N) and
// cnt (int32, one per tile: S * ceil(M / bm) * ceil(N / bn), zero); the
// kernel leaves cnt zero.
extern "C" int rns_matmul(const void* a, const void* b, int S, int M, int N,
                          int D, int lim, const RnsTables* t, void* out,
                          int in_int8, int bm, int bn, int splits, void* ws,
                          void* cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lim < BK) return cudaErrorInvalidValue;
#define RNS_MATMUL_TILE(m, n)                                             \
  if (bm == m && bn == n)                                                 \
    return in_int8 ? launch<int8_t, m, n>(a, b, S, M, N, D, lim, splits,  \
                                          *t, out, ws, cnt, st)           \
                   : launch<int32_t, m, n>(a, b, S, M, N, D, lim, splits, \
                                           *t, out, ws, cnt, st);
  RNS_MATMUL_TILE(32, 64) RNS_MATMUL_TILE(64, 64) RNS_MATMUL_TILE(32, 128)
  RNS_MATMUL_TILE(64, 128)
#undef RNS_MATMUL_TILE
  return cudaErrorInvalidValue;
}
