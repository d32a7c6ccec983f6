// A design candidate of the fused encode + matmul (B.5), one digit's
// tile a block, built and timed only by scripts/kernel_variants.py
// (studies encode_layout, encode_parts, encode_coltiles) beside the
// kernel the port runs, rns_encode_residues_kernel of
// src/repro_torch/kernels/rns_fused/csrc/rns_fused_mma.cu (all K digits of
// a tile in one block), which measured faster in both main-path rows
// (PERF.md).  It is rns_matmul.cu's design (rns_matmul_kernel, B.2) with
// x quantized in the block:
//
//   rns_encode_matmul_kernel  x f32 [M, D] with one scale per run of
//                             `group` rows, b [K, D, N] -> the residues of
//                             quantize(x, s) @ b[k] mod m_k, int32
//                             [K, M, N].
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
// threads into the same ring.  A rows keep D
// contiguous, as the MMA's row operand wants; b is N-contiguous but the
// .col operand wants 4 consecutive k of one column in a register: each
// thread reads a 4 x 4 byte block (4 k rows, 4 columns) and transposes it
// with __byte_perm, which gives the B registers of 4 n8 tiles, the tile j
// holding columns 4g + j of the warp's 32 (g = lane / 4).
//
// Quantize prologue: the ring carries b alone.  A block quantizes
// its x rows once for up to DCH K steps of its share of D (all of it on
// the main path) into a resident byte tile [BM][cst * 128 + 16]
// (csrc/rns_quantize.cuh, the rule of rns_convert): a warp a row, a lane
// a float4 of each K step, the row's loads issued at once while b's
// first copies are in flight; then the K loop is rns_matmul's, its a
// fragments read from that tile.  Without a split a block walks `ntile`
// column tiles on the same quantized rows, b's ring streaming on from
// one tile to the next (rns_matmul.col_tiles_for: fewer requantizations
// where the tiles outnumber the SMs).  At qmax <= 127 (bits <= 8, the
// main path; the SGN instantiations) the quantized values themselves are
// the a operand, as signed bytes (s8 x u8 MMAs: sum v.b is congruent to
// sum (v mod m).b, and the signed sums are reduced by a floor-mod,
// signed_mod); wider values are reduced to the block's own digit
// (quant_residue) and multiplied as u8.  Rows past M that an MMA reads
// are zero.  x is re-read once per digit and walk of column tiles, from
// L2.  (Quantizing x one K step at a time, staged through the ring or
// fetched a step ahead, measured slower: PERF.md.)
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

#include <type_traits>

#include "rns_mma.cuh"
#include "rns_quantize.cuh"
#include "rns_tables.cuh"

constexpr int BK = 128;             // K step: four k32 MMAs
constexpr int STAGES = 3;           // shared-memory ring
constexpr int PAD = 16;             // bytes after each staged row
constexpr int AST = BK + PAD;       // A row stride (bytes): 36 words,
                                    // conflict-free fragment loads
constexpr int DCH = 8;              // B.5: K steps of x quantized at once

// Q: the a operand is float x, quantized in the block (B.5)
template <bool Q, int BM, int BN>
struct Tile {
  static_assert(BM % 16 == 0 && BN % 32 == 0, "m16 rows, 32-column warps");
  static constexpr int THREADS = BN;          // one warp per 32 columns
  static constexpr int MI = BM / 16;          // m16 MMA rows per warp
  static constexpr int BST = BN + PAD;        // B row stride (bytes)
  static constexpr int ASTAGE = Q ? 0 : BM * AST;
  static constexpr int STAGE = ASTAGE + BK * BST;
  static constexpr int RING = STAGES * STAGE;
  // the ring, then (Q) the quantized rows of cst K steps
  static constexpr int smem(int cst) {
    return RING + (Q ? BM * (cst * BK + PAD) : 0);
  }
};

// One block's tiles of one digit: `ntile` column tiles of BN, one after
// another (1 but for B.5 without a split).  AT: a's elements -- int8 /
// int32 residues [S, M, D], or float x [M, D] (B.5, with the row scales
// sc); BT: b's, int8 / int32 residues [S, D, N].  SGN (B.5 at qmax <=
// 127): the quantized x is the a operand as signed bytes.
template <typename AT, typename BT, int BM, int BN, bool SGN = false>
__device__ __forceinline__ void matmul_tile(
    const AT* __restrict__ a, const float* __restrict__ sc, long long group,
    float qmax, const BT* __restrict__ b, int M, int N, int D, int lim,
    int per, int splits, int ntile, bool a_vec, bool b_vec,
    const RnsTables& t, int32_t* __restrict__ out, int32_t* __restrict__ ws,
    int32_t* __restrict__ cnt) {
  constexpr bool Q = std::is_same<AT, float>::value;
  using L = Tile<Q, BM, BN>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int s = blockIdx.z / splits, split = blockIdx.z % splits;
  const int m = t.moduli[s];
  const unsigned magic = t.magic[s];
  const AT* A = Q ? a : a + (long long)s * M * D;
  const BT* B = b + (long long)s * D * N;
  const int row0 = blockIdx.y * BM;
  const int ct0 = blockIdx.x * ntile;         // the block's first column tile
  const int lane = threadIdx.x % 32, wn = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const int ksteps = (D + BK - 1) / BK;
  const int kb = split * per, n = min(ksteps, kb + per) - kb;
  // ring steps: n K steps of each column tile the block walks
  const int steps = n * min(ntile, (N + BN - 1) / BN - ct0);
  const bool narrow = qmax <= 65535.f;        // quant_residue<true>
  // rows some MMA reads (m16 tiles that hold a row below M), rows below M
  const int qrows = min(BM, (M - row0 + 15) / 16 * 16);
  const int vrows = min(BM, M - row0);
  // Q: K steps of quantized x held at once, their row stride, after the
  // ring
  const int cst = min(per, DCH), aq = cst * BK + PAD;
  uint8_t* qa = smem + L::RING;

  // ring step u (K step kb + u % n of column tile ct0 + u / n): a rows
  // [row0, row0 + BM) (not for Q) and b's BN columns into ring slot u %
  // STAGES; out-of-range elements are zero
  auto stage = [&](int u) {
    uint8_t* sa = smem + (u % STAGES) * L::STAGE;
    uint8_t* sb = sa + L::ASTAGE;
    const int k0 = (kb + u % n) * BK, col0 = (ct0 + u / n) * BN;
    if constexpr (!Q && sizeof(AT) == 1) {
      if (a_vec)
        stage_async<AT, BM, BK, L::THREADS>(sa, 0, AST, A, 0, D, M, D, row0,
                                            k0);
      else
        stage_elems<AT, BM, BK, L::THREADS>(sa, 0, AST, A, 0, D, M, D, row0,
                                            k0);
    } else if constexpr (!Q) {      // int32 residues, narrowed to u8
      stage_elems<AT, BM, BK, L::THREADS>(sa, 0, AST, A, 0, D, M, D, row0,
                                          k0);
    }
    if constexpr (sizeof(BT) == 1) {
      if (b_vec) {
        stage_async<BT, BK, BN, L::THREADS>(sb, 0, L::BST, B, 0, N, D, N, k0,
                                            col0);
        return;
      }
    }
    stage_elems<BT, BK, BN, L::THREADS>(sb, 0, L::BST, B, 0, N, D, N, k0,
                                        col0);
  };

  // Q: x rows [row0, row0 + vrows) of the cn K steps from k0 -> qa: s8
  // values (SGN) or the digit's u8 residues, columns past D zero.  A warp
  // takes a row at a time, each lane one float4 of each K step, every
  // load of the row (and its scale) issued first.
  auto quantize = [&](int k0, int cn) {
    if constexpr (Q) {
      const int grp = (int)(group < M ? group : M);
#pragma unroll 2
      for (int r = wn; r < vrows; r += L::THREADS / 32) {
        const float* xr = A + (long long)(row0 + r) * D + k0 + 4 * lane;
        const float f = sc[(row0 + r) / grp];
        float4 xv[DCH];
#pragma unroll
        for (int j = 0; j < DCH; ++j) {
          const int gk = k0 + BK * j + 4 * lane;
          const float* px = xr + BK * j;
          xv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j < cn && gk < D) {
            if (a_vec) {
              xv[j] = *(const float4*)px;
            } else {
              xv[j].x = px[0];
              if (gk + 1 < D) xv[j].y = px[1];
              if (gk + 2 < D) xv[j].z = px[2];
              if (gk + 3 < D) xv[j].w = px[3];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < DCH; ++j) {
          if (j >= cn) break;
          const int4 v = make_int4(
              quantize_rn(xv[j].x, f, qmax), quantize_rn(xv[j].y, f, qmax),
              quantize_rn(xv[j].z, f, qmax), quantize_rn(xv[j].w, f, qmax));
          uint32_t w;
          if constexpr (SGN) {
            w = low_bytes(v);
          } else {
            auto res = [&](int x) {
              return (uint32_t)(narrow ? quant_residue<true>(x, s, t)
                                       : quant_residue<false>(x, s, t));
            };
            w = res(v.x) | res(v.y) << 8 | res(v.z) << 16 | res(v.w) << 24;
          }
          *(uint32_t*)(qa + r * aq + BK * j + 4 * lane) = w;
        }
      }
    }
  };

  int acc[L::MI][4][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < L::MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  };
  auto reduce = [&]() {             // every accumulator mod m
#pragma unroll
    for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][j][e] = SGN ? signed_mod(acc[mi][j][e], m, magic)
                              : mulhi_mod(acc[mi][j][e], m, magic);
  };

  // fragment (mi, j, e) is row 16 mi + g + 8 (e / 2), column
  // 32 wn + 8 tq + 4 (e % 2) + j of the tile: each thread owns 8
  // consecutive columns of 2 MI rows.  Write (or, with add, first add the
  // other splits' slices to) them into P (row stride N) for the column
  // tile at col0.
  int32_t* O = out + (long long)s * M * N;
  const bool vout = N % 4 == 0;     // 16-byte stores
  auto emit = [&](int32_t* P, int col0, bool add) {
    const int cbase = col0 + 32 * wn + 8 * tq;
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
          for (int j = 0; j < 4; ++j) v[j] = mulhi_mod(v[j], m, magic);
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

#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < steps) stage(u);
    cp_async_commit();
  }
  if constexpr (Q) {                // rows past M an MMA reads
    for (int e = threadIdx.x; e < (qrows - vrows) * aq / 4;
         e += L::THREADS)
      ((uint32_t*)(qa + vrows * aq))[e] = 0;
  }
  const int ast = Q ? aq : AST;     // a's row stride in shared memory
  zero();
  if (n == 0) {                     // D = 0: every residue is 0
    for (int u = 0; u < min(ntile, (N + BN - 1) / BN - ct0); ++u)
      emit(O, (ct0 + u) * BN, false);
    return;
  }
  int since = 0;                    // terms accumulated since a reduction
  for (int u = 0; u < steps; ++u) {
    const int i = u % n;            // the K step in the column tile
    if constexpr (Q) {              // x of the next DCH steps, quantized
      if (i % cst == 0 && (u < n || cst < n)) {   // (held across tiles)
        if (u) __syncthreads();     // every warp is done with the last
        quantize((kb + i) * BK, min(cst, n - i));
      }
    }
    cp_async_wait<STAGES - 2>();    // this thread's copies of step u
    __syncthreads();                // everyone's (and qa); slot u-1 free
    if (u + STAGES - 1 < steps) stage(u + STAGES - 1);
    cp_async_commit();
    const uint8_t* sA = Q ? qa + (i % cst) * BK
                          : smem + (u % STAGES) * L::STAGE;
    const uint8_t* sB = smem + (u % STAGES) * L::STAGE + L::ASTAGE;
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
        if (16 * mi >= qrows) continue;       // warp-uniform: no rows
        const uint8_t* p = sA + (16 * mi + g) * ast + 32 * kh + 4 * tq;
        const uint32_t a0 = *(const uint32_t*)p;
        const uint32_t a1 = *(const uint32_t*)(p + 8 * ast);
        const uint32_t a2 = *(const uint32_t*)(p + 16);
        const uint32_t a3 = *(const uint32_t*)(p + 8 * ast + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (SGN)
            mma_s8u8(acc[mi][j], a0, a1, a2, a3, b0[j], b1[j]);
          else
            mma_u8(acc[mi][j], a0, a1, a2, a3, b0[j], b1[j]);
        }
      }
    }
    since += BK;
    if (since + BK > lim) {         // the next step could overflow int32
      reduce();
      since = 0;
    }
    if (i < n - 1) continue;
    // the column tile's last K step: its residues out
    reduce();
    const int col0 = (ct0 + u / n) * BN;
    if (splits == 1) {
      emit(O, col0, false);
      zero();
      since = 0;
      continue;
    }
    // a split (ntile == 1): this split's slice, and the last block of the
    // tile adds the others'
    emit(ws + (long long)blockIdx.z * M * N, col0, false);
    __threadfence();                // the slice before the count
    __syncthreads();
    const int tile = (s * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(cnt + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    emit(O, col0, true);
    if (threadIdx.x == 0) cnt[tile] = 0;
  }
  cp_async_wait<0>();
}

template <typename BT, int BM, int BN, bool SGN>
__global__ void __launch_bounds__(BN)
rns_encode_matmul_kernel(const float* __restrict__ x,
                         const float* __restrict__ sc, long long group,
                         float qmax, const BT* __restrict__ b, int M, int N,
                         int D, int lim, int per, int splits, int ntile,
                         bool x_vec, bool b_vec,
                         const __grid_constant__ RnsTables t,
                         int32_t* __restrict__ out, int32_t* __restrict__ ws,
                         int32_t* __restrict__ cnt) {
  matmul_tile<float, BT, BM, BN, SGN>(x, sc, group, qmax, b, M, N, D, lim,
                                      per, splits, ntile, x_vec, b_vec, t,
                                      out, ws, cnt);
}

// The K steps each split takes (`per`) and the split count as the kernel
// sees it (no split without K steps); false for a bad request.
static bool plan_splits(int D, int lim, int& splits, int& per, void* ws,
                        void* cnt) {
  if (lim < BK || splits < 1 ||
      (splits > 1 && (ws == nullptr || cnt == nullptr)))
    return false;
  const int ksteps = (D + BK - 1) / BK;
  per = (ksteps + splits - 1) / splits;
  if (per < 1) per = 1;
  splits = (ksteps + per - 1) / per;
  if (splits < 1) splits = 1;
  return true;
}

template <typename Kern>
static cudaError_t opt_in(Kern kern, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename BT, int BM, int BN>
static int launch_encode(const void* x, const void* s, long long group,
                         float qmax, const void* b, int M, int N, int D,
                         int lim, int splits, int ntile, const RnsTables& t,
                         void* out, void* ws, void* cnt, cudaStream_t st) {
  using L = Tile<true, BM, BN>;
  int per;
  if (group < 1 || ntile < 1 || !plan_splits(D, lim, splits, per, ws, cnt))
    return (int)cudaErrorInvalidValue;
  // a split tile's blocks walk one column tile, and so does a block
  // whose share of D outgrows the DCH resident steps (the next tile's
  // first step would reuse a column this tile's last step reads)
  if (splits > 1 || per > DCH) ntile = 1;
  const bool x_vec = D % 4 == 0 && (uintptr_t)x % 16 == 0;  // float4s
  const bool b_vec = sizeof(BT) == 1 && N % 16 == 0 &&
                     (uintptr_t)b % 16 == 0;
  // s8 a operand (qmax <= 127) or the digit's residues
  auto kern = qmax <= 127.f ? rns_encode_matmul_kernel<BT, BM, BN, true>
                            : rns_encode_matmul_kernel<BT, BM, BN, false>;
  const cudaError_t err = opt_in(kern, L::smem(DCH));
  if (err != cudaSuccess) return (int)err;
  const int ctiles = (N + BN - 1) / BN;
  const dim3 grid((ctiles + ntile - 1) / ntile, (M + BM - 1) / BM,
                  t.K * splits);
  kern<<<grid, L::THREADS, L::smem(per < DCH ? per : DCH), st>>>(
      (const float*)x, (const float*)s, group, qmax, (const BT*)b, M, N, D,
      lim, per, splits, ntile, x_vec, b_vec, t, (int32_t*)out,
      (int32_t*)ws, (int32_t*)cnt);
  return (int)cudaGetLastError();
}

// Calls f(bm, bn) with the compiled tile (analysis/kernel_audit.py
// MATMUL_TILES) as std::integral_constants.
template <typename F>
static int with_tile(int bm, int bn, F&& f) {
#define RNS_MATMUL_TILE(m, n)                                   \
  if (bm == m && bn == n)                                       \
    return f(std::integral_constant<int, m>{},                  \
             std::integral_constant<int, n>{});
  RNS_MATMUL_TILE(32, 64) RNS_MATMUL_TILE(64, 64) RNS_MATMUL_TILE(32, 128)
  RNS_MATMUL_TILE(64, 128)
#undef RNS_MATMUL_TILE
  return (int)cudaErrorInvalidValue;
}

// The fused encode + matmul, one digit a block: x [M, D] float32; s
// [M / group] float32, one scale per run of `group` rows; qmax =
// 2^(bits-1) - 1; b [K, D, N] int8 (b_int8) or int32 residues, K = t->K;
// out [K, M, N] int32.  Tiles, lim and the split workspace as for
// rns_matmul (S = K); without a split a block walks `ntile` column tiles
// of bn on its quantized rows.
extern "C" int rns_fused_encode_matmul(const void* x, const void* s,
                                       long long group, float qmax,
                                       const void* b, int b_int8, int M,
                                       int N, int D, int lim,
                                       const RnsTables* t, void* out, int bm,
                                       int bn, int splits, void* ws,
                                       void* cnt, int ntile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    constexpr int TBM = decltype(tm)::value, TBN = decltype(tn)::value;
    return b_int8 ? launch_encode<int8_t, TBM, TBN>(x, s, group, qmax, b, M,
                                                    N, D, lim, splits, ntile,
                                                    *t, out, ws, cnt, st)
                  : launch_encode<int32_t, TBM, TBN>(x, s, group, qmax, b, M,
                                                     N, D, lim, splits, ntile,
                                                     *t, out, ws, cnt, st);
  });
}
