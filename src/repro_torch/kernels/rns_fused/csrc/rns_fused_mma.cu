// Fused residue datapath on the integer tensor cores: one projection's
// digit matmul with its forward conversion, its MRC normalize or both in
// one kernel, every digit's accumulators and residues on chip.
//
//   rns_fused_dot              x f32 [M,D] (+ row scales), b [K,D,N]
//                              -> [M,N] float32 (unscaled)
//   rns_fused_matmul_normalize a [K,M,D] residues, b [K,D,N]
//                              -> [M,N] float32 (unscaled)
//   rns_fused_encode_matmul    x f32 [M,D] (+ row scales), b [K,D,N]
//                              -> [K,M,N] int32 residues
//
// They replace the Pallas kernels rns_fused_dot_tiles,
// rns_fused_matmul_normalize_tiles and rns_fused_encode_matmul_tiles of
// src/repro/kernels/rns_fused/kernel.py; see kernels/rns_fused/ops.py for
// the bound and design.  The first two run rns_fused_mma_kernel, the
// encode + matmul the same body as rns_encode_residues_kernel.
//
// * A block owns a BM x BN output tile for ALL K digits: BN / 32 warps a
//   digit (K * BN threads), each warp BM rows x 32 columns of its digit's
//   int32 accumulators in registers.  Products: mma.sync.m16n8k32 with u8
//   b (csrc/rns_mma.cuh, as rns_matmul.cu), reduced mod m every `lim` =
//   lazy_chunk - 1 terms: at D = 16384 (MLA's wo, the widest reduction
//   served) a digit sums at most 16384 * 255^2 = 1.07e9 (u8 a) or
//   16384 * 128 * 255 = 5.3e8 in magnitude (s8 a) < 2^31 between
//   reductions.
// * K steps come through a ring of shared-memory stages filled by 16-byte
//   cp.async (int32 b or ragged widths: element by element, b narrowed to
//   u8).  a's residues are staged as they come, int8 or int32 (the
//   deferred path), and the int32 ones are narrowed to bytes as the MMA
//   fragments are read, so a has the same copies in flight as b.
// * The dot stages x as float32 and quantizes the tile once a step
//   (csrc/rns_quantize.cuh, the bits of rns_convert).  When the quantized
//   values fit a signed byte (bits <= 8, the main path), that one s8 tile
//   is every digit's a operand (s8 x u8 MMAs: sum v.b is congruent to
//   sum (v mod m).b, and the signed sums are reduced by a floor-mod);
//   otherwise the block reduces it to every digit's u8 residues.
// * The ring's K step and depth (Ring, mirrored by
//   analysis/kernel_audit.py) are the deepest of (128, 3), (64, 3),
//   (64, 2), (32, 3), (32, 2) whose shared memory fits.
// * Split over D (decode): `splits` blocks share a tile's K steps; each
//   stores its digits' residues mod m in its slice of the workspace `ws`,
//   and the last to finish (a per-tile atomic counter, which it sets back
//   to zero) adds the other slices: order-free integer sums, one launch,
//   graph-safe, as in rns_matmul.cu.
// * Epilogue: the tile's K x BM x BN residues are parked in shared memory
//   (aliasing the ring) and all K * BN threads run the MRC of
//   csrc/rns_mrc.cuh (one pass of multiply-high mods, as rns_normalize.cu),
//   one output element each: the same bits as core/mrc.decode_float.  The
//   encode + matmul (RES) stores each warp's residues from its registers
//   instead, 16 bytes at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rns_mma.cuh"
#include "rns_mrc.cuh"
#include "rns_quantize.cuh"

constexpr int PAD = 16;             // bytes after each staged u8 row
constexpr int XPAD = 4;             // floats after each staged x row
constexpr int IPAD = 16;            // ints after each staged int32 or
                                    // quantized row: the 16-byte fragment
                                    // reads of 8 lanes on distinct banks
constexpr int FLAG = 16;            // bytes for the split's "last" flag
constexpr int SMEM_MAX = 232448;    // 227 KiB, after cudaFuncSetAttribute

// Shared memory of one stage at K step bk: b's K u8 tiles [bk][BN + 16],
// then a's K tiles sized for int32 [BM][bk + 16] or (Q, the dot) the
// float32 x tile [BM][bk + 4].
__host__ __device__ constexpr int stage_bytes(bool q, int K, int BM, int BN,
                                              int bk) {
  return K * bk * (BN + PAD) +
         (q ? BM * (bk + XPAD) * 4 : K * BM * (bk + IPAD) * 4);
}
// One block: the ring, then (Q) the digits' u8 tiles, the quantized tile
// and the row scales; the epilogue's K x BM x BN residues alias it all.
__host__ __device__ constexpr int smem_bytes(bool q, int K, int BM, int BN,
                                             int bk, int st) {
  const int body = st * stage_bytes(q, K, BM, BN, bk) +
                   (q ? K * BM * (bk + PAD) + BM * (bk + IPAD) * 4 + BM * 4
                      : 0);
  const int park = K * BM * BN * 4;
  return (body > park ? body : park) + FLAG;
}
__host__ __device__ constexpr bool fits(bool q, int K, int BM, int BN, int bk,
                                       int st) {
  return smem_bytes(q, K, BM, BN, bk, st) <= SMEM_MAX;
}

template <bool Q, int K, int BM, int BN>
struct Ring {
  static constexpr int R = fits(Q, K, BM, BN, 128, 3)  ? 0
                           : fits(Q, K, BM, BN, 64, 3) ? 1
                           : fits(Q, K, BM, BN, 64, 2) ? 2
                           : fits(Q, K, BM, BN, 32, 3) ? 3
                                                       : 4;
  static constexpr int BK = R == 0 ? 128 : R <= 2 ? 64 : 32;
  static constexpr int STAGES = R == 2 || R == 4 ? 2 : 3;
  static constexpr int SMEM = smem_bytes(Q, K, BM, BN, BK, STAGES);
  static constexpr bool FITS = SMEM <= SMEM_MAX;
};

// One block's tile.  AT: float (x, quantized in the kernel) or int8 /
// int32 residues [K, M, D]; BT: int8 / int32 residues [K, D, N]; K ==
// t.K.  s8: (x) the quantized x fits a signed byte, qmax <= 127.  RES
// (the fused encode + matmul): the epilogue stores the digits' residues,
// int32 [K, M, N] at out, in place of the MRC's floats.
template <typename AT, typename BT, int K, int BM, int BN, bool RES>
__device__ __forceinline__ void fused_tile(
    const AT* __restrict__ a, const float* __restrict__ s, long long group,
    float qmax, const BT* __restrict__ b, int M, int N, int D, int lim,
    int per, int splits, bool a_vec, bool b_vec, bool s8, const RnsTables& t,
    void* __restrict__ out, int32_t* __restrict__ ws,
    int32_t* __restrict__ cnt) {
  constexpr bool Q = std::is_same<AT, float>::value;
  constexpr bool A32 = !Q && sizeof(AT) == 4;
  using RG = Ring<Q, K, BM, BN>;
  constexpr int BK = RG::BK, STAGES = RG::STAGES;
  constexpr int NT = K * BN;                  // threads
  constexpr int WPD = BN / 32;                // warps a digit
  constexpr int MI = BM / 16;                 // m16 MMA rows a warp
  constexpr int BST = BN + PAD, AST = BK + PAD;   // u8 row strides
  constexpr int IST = BK + IPAD;              // int32 row stride (ints)
  constexpr int XST = BK + XPAD;              // x row stride (floats)
  constexpr int ADIG = BM * IST * 4;          // a's digit tiles apart
  constexpr int BBYTES = K * BK * BST;        // a stage's b tiles
  constexpr int STAGE = stage_bytes(Q, K, BM, BN, BK);
  static_assert(BM % 16 == 0 && BN % 32 == 0, "m16 rows, 32-column warps");
  static_assert(RG::FITS, "no ring fits in shared memory");

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qa = smem + STAGES * STAGE;        // Q: the digits' u8 tiles
  int* V = (int*)(qa + K * BM * AST);         // Q: quantized x [BM][IST]
  float* sS = (float*)(V + BM * IST);         // Q: row scales
  int* last = (int*)(smem + RG::SMEM - FLAG);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dg = warp / WPD, wn = warp % WPD;
  const int g = lane / 4, tq = lane % 4;
  const int m = t.moduli[dg];
  const unsigned magic = t.magic[dg];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x, split = blockIdx.z;
  const int ksteps = (D + BK - 1) / BK;
  const int kb = split * per, n = min(ksteps, kb + per) - kb;
  const bool sgn = Q && s8;         // s8 a: one tile for every digit

  if constexpr (Q) {
    for (int r = threadIdx.x; r < BM; r += NT)
      sS[r] = row0 + r < M ? s[(row0 + r) / group] : 0.f;
  }

  // K step ks of b and a into ring slot `slot`
  auto stage = [&](int slot, int ks) {
    uint8_t* st = smem + slot * STAGE;
    uint8_t* sa = st + BBYTES;
    const int k0 = ks * BK;
    const long long bmat = (long long)D * N, amat = (long long)M * D;
    if constexpr (sizeof(BT) == 1) {
      if (b_vec)
        stage_async<BT, BK, BN, NT, K>(st, BK * BST, BST, b, bmat, N, D, N,
                                       k0, col0);
      else
        stage_elems<BT, BK, BN, NT, K>(st, BK * BST, BST, b, bmat, N, D, N,
                                       k0, col0);
    } else {
      stage_elems<BT, BK, BN, NT, K>(st, BK * BST, BST, b, bmat, N, D, N, k0,
                                     col0);
    }
    if constexpr (Q) {
      if (a_vec)
        stage_async<float, BM, BK, NT>(sa, 0, XST * 4, a, 0, D, M, D, row0,
                                       k0);
      else
        stage_elems<float, BM, BK, NT, 1, float>(sa, 0, XST * 4, a, 0, D, M,
                                                 D, row0, k0);
    } else if constexpr (A32) {     // as int32, narrowed when read
      if (a_vec)
        stage_async<AT, BM, BK, NT, K>(sa, ADIG, IST * 4, a, amat, D, M, D,
                                       row0, k0);
      else
        stage_elems<AT, BM, BK, NT, K, int>(sa, ADIG, IST * 4, a, amat, D, M,
                                            D, row0, k0);
    } else {                        // int8 residues as u8
      if (a_vec)
        stage_async<AT, BM, BK, NT, K>(sa, ADIG, AST, a, amat, D, M, D, row0,
                                       k0);
      else
        stage_elems<AT, BM, BK, NT, K>(sa, ADIG, AST, a, amat, D, M, D, row0,
                                       k0);
    }
  };

  // Q: the x tile -> clip(rint(x * s)) once a step: as s8 bytes into the
  // first u8 tile (s8), or as ints into V, reduced by `residues` to every
  // digit's u8 residues (floor-mod: |v| by mulhi_mod, reflected for v <
  // 0); rows past M are zero
  auto quantize = [&](const uint8_t* st) {
    const float* X = (const float*)(st + BBYTES);
    for (int e = threadIdx.x; e < BM * BK / 4; e += NT) {
      const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
      const float4 x = *(const float4*)(X + r * XST + c);
      const float sc = sS[r];
      const int4 v =
          make_int4(quantize_rn(x.x, sc, qmax), quantize_rn(x.y, sc, qmax),
                    quantize_rn(x.z, sc, qmax), quantize_rn(x.w, sc, qmax));
      if (sgn)
        *(uint32_t*)(qa + r * AST + c) = low_bytes(v);
      else
        *(int4*)(V + r * IST + c) = v;
    }
  };
  auto residues = [&]() {
    for (int e = threadIdx.x; e < K * BM * BK / 4; e += NT) {
      const int j = e / (BM * BK / 4);
      const int r = e % (BM * BK / 4) / (BK / 4), c = 4 * (e % (BK / 4));
      uint32_t word = 0;
      if (row0 + r < M) {
        const int mj = t.moduli[j];
        const unsigned mg = t.magic[j];
        const int4 v = *(const int4*)(V + r * IST + c);
        auto res = [&](int x) {
          const int q = mulhi_mod(abs(x), mj, mg);
          return (uint32_t)(x < 0 && q ? mj - q : q);
        };
        word = res(v.x) | res(v.y) << 8 | res(v.z) << 16 | res(v.w) << 24;
      }
      *(uint32_t*)(qa + (j * BM + r) * AST + c) = word;
    }
  };

  int acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  auto reduce = [&]() {             // every accumulator mod m
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][j][e] = Q ? signed_mod(acc[mi][j][e], m, magic)
                            : mulhi_mod(acc[mi][j][e], m, magic);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) stage(i, kb + i);
    cp_async_commit();
  }
  int since = 0;                    // terms accumulated since a reduction
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();    // this thread's copies of step i
    __syncthreads();                // everyone's; slot i-1 is consumed
    const int nx = i + STAGES - 1;
    if (nx < n) stage(nx % STAGES, kb + nx);
    cp_async_commit();
    const uint8_t* st = smem + (i % STAGES) * STAGE;
    const uint8_t* sA = st + BBYTES + dg * ADIG;
    if constexpr (Q) {
      quantize(st);
      __syncthreads();
      if (!sgn) {
        residues();
        __syncthreads();
      }
      sA = qa + (sgn ? 0 : dg * BM * AST);
    }
    const uint8_t* sB = st + dg * BK * BST;
#pragma unroll
    for (int kh = 0; kh < BK / 32; ++kh) {
      uint32_t b0[4], b1[4];        // rows 4tq + r (b0), 16 + 4tq + r (b1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint8_t* p = sB + (32 * kh + 4 * tq + r) * BST + 32 * wn + 4 * g;
        b0[r] = *(const uint32_t*)p;
        b1[r] = *(const uint32_t*)(p + 16 * BST);
      }
      transpose4x4(b0);
      transpose4x4(b1);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (row0 + 16 * mi >= M) continue;    // warp-uniform: no rows
        uint32_t a0, a1, a2, a3;    // rows g, g + 8; k 4tq.., 16 + 4tq..
        if constexpr (A32) {
          const int* p = (const int*)sA + (16 * mi + g) * IST + 32 * kh +
                         4 * tq;
          a0 = low_bytes(*(const int4*)p);
          a1 = low_bytes(*(const int4*)(p + 8 * IST));
          a2 = low_bytes(*(const int4*)(p + 16));
          a3 = low_bytes(*(const int4*)(p + 8 * IST + 16));
        } else {
          const uint8_t* p = sA + (16 * mi + g) * AST + 32 * kh + 4 * tq;
          a0 = *(const uint32_t*)p;
          a1 = *(const uint32_t*)(p + 8 * AST);
          a2 = *(const uint32_t*)(p + 16);
          a3 = *(const uint32_t*)(p + 8 * AST + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (sgn)
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
  }
  cp_async_wait<0>();
  reduce();

  // fragment (mi, j, h) is row 16 mi + g + 8 (h / 2), column
  // 32 wn + 8 tq + 4 (h % 2) + j of the digit's BM x BN tile at P; the
  // split slices skip rows past M (decode: 8 of a tile's 16)
  auto frag = [&](int32_t* P, int mi, int h) {
    return P + (16 * mi + g + 8 * (h / 2)) * BN + 32 * wn + 8 * tq +
           4 * (h % 2);
  };
  auto live = [&](int mi, int h) {
    return row0 + 16 * mi + g + 8 * (h / 2) < M;
  };
  if (splits > 1) {
    int32_t* W = ws + (long long)tile * splits * K * BM * BN;
    int32_t* mine = W + ((long long)split * K + dg) * BM * BN;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (live(mi, h))
          *(int4*)frag(mine, mi, h) =
              make_int4(acc[mi][0][h], acc[mi][1][h], acc[mi][2][h],
                        acc[mi][3][h]);
    __threadfence();                // the slice before the count
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(cnt + tile, 1) == splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int sp = 0; sp < splits; ++sp) {
      if (sp == split) continue;
      int32_t* other = W + ((long long)sp * K + dg) * BM * BN;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          if (!live(mi, h)) continue;
          const int4 o = __ldcg((const int4*)frag(other, mi, h));
          acc[mi][0][h] += o.x;
          acc[mi][1][h] += o.y;
          acc[mi][2][h] += o.z;
          acc[mi][3][h] += o.w;
        }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][j][e] = mulhi_mod(acc[mi][j][e], m, magic);
    if (threadIdx.x == 0) cnt[tile] = 0;
  }

  if constexpr (RES) {              // the residues, 16-byte stores
    int32_t* O = (int32_t*)out + (long long)dg * M * N;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int gm = row0 + 16 * mi + g + 8 * (h / 2);
        const int gn = col0 + 32 * wn + 8 * tq + 4 * (h % 2);
        if (gm >= M || gn >= N) continue;
        int32_t* dst = O + (long long)gm * N + gn;
        if (N % 4 == 0) {
          *(int4*)dst = make_int4(acc[mi][0][h], acc[mi][1][h],
                                  acc[mi][2][h], acc[mi][3][h]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) dst[j] = acc[mi][j][h];
        }
      }
    return;
  }

  // park the residues [K][BM][BN] over the ring, then the MRC of each
  // output element by one thread
  __syncthreads();                  // every warp is done with the ring
  int32_t* Rs = (int32_t*)smem;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      *(int4*)frag(Rs + dg * BM * BN, mi, h) =
          make_int4(acc[mi][0][h], acc[mi][1][h], acc[mi][2][h],
                    acc[mi][3][h]);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    const int gm = row0 + r, gc = col0 + c;
    if (gm >= M || gc >= N) continue;
    int res[K];
#pragma unroll
    for (int j = 0; j < K; ++j) res[j] = Rs[(j * BM + r) * BN + c];
    ((float*)out)[(long long)gm * N + gc] = mrc_decode_float<K>(res, t);
  }
}

// The dot and the matmul + normalize: [M, N] float32 out.
template <typename AT, typename BT, int K, int BM, int BN>
__global__ void __launch_bounds__(K * BN)
rns_fused_mma_kernel(const AT* __restrict__ a, const float* __restrict__ s,
                     long long group, float qmax, const BT* __restrict__ b,
                     int M, int N, int D, int lim, int per, int splits,
                     bool a_vec, bool b_vec, bool s8,
                     const __grid_constant__ RnsTables t,
                     float* __restrict__ out, int32_t* __restrict__ ws,
                     int32_t* __restrict__ cnt) {
  fused_tile<AT, BT, K, BM, BN, false>(a, s, group, qmax, b, M, N, D, lim,
                                       per, splits, a_vec, b_vec, s8, t, out,
                                       ws, cnt);
}

// The fused encode + matmul: [K, M, N] int32 residues out, under its own
// name (a profile tells its device time from the dot's).
template <typename BT, int K, int BM, int BN>
__global__ void __launch_bounds__(K * BN)
rns_encode_residues_kernel(const float* __restrict__ x,
                           const float* __restrict__ s, long long group,
                           float qmax, const BT* __restrict__ b, int M,
                           int N, int D, int lim, int per, int splits,
                           bool x_vec, bool b_vec, bool s8,
                           const __grid_constant__ RnsTables t,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ ws,
                           int32_t* __restrict__ cnt) {
  fused_tile<float, BT, K, BM, BN, true>(x, s, group, qmax, b, M, N, D, lim,
                                         per, splits, x_vec, b_vec, s8, t,
                                         out, ws, cnt);
}

template <typename AT, typename BT, int K, int BM, int BN, bool RES = false>
static int launch(const void* a, const void* s, long long group, float qmax,
                  const void* b, int M, int N, int D, int lim, int splits,
                  const RnsTables& t, void* out, void* ws, void* cnt,
                  cudaStream_t st) {
  constexpr bool Q = std::is_same<AT, float>::value;
  using RG = Ring<Q, K, BM, BN>;
  if constexpr (K * BN > 1024 || !RG::FITS) {
    return (int)cudaErrorInvalidValue;   // not built: the checker refuses it
  } else {
    if (t.K != K || lim < RG::BK || splits < 1 ||
        (splits > 1 && (ws == nullptr || cnt == nullptr)))
      return (int)cudaErrorInvalidValue;
    const int ksteps = (D + RG::BK - 1) / RG::BK;
    int per = (ksteps + splits - 1) / splits;
    if (per < 1) per = 1;
    splits = (ksteps + per - 1) / per;   // no split without K steps
    if (splits < 1) splits = 1;
    const bool a_vec = (uintptr_t)a % 16 == 0 &&
                       D % (sizeof(AT) == 1 ? 16 : 4) == 0;
    const bool b_vec = sizeof(BT) == 1 && (uintptr_t)b % 16 == 0 &&
                       N % 16 == 0;
    const bool s8 = Q && qmax <= 127.f;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    auto go = [&](auto kern, auto* o) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RG::SMEM);
      if (err != cudaSuccess) return (int)err;
      kern<<<grid, K * BN, RG::SMEM, st>>>(
          (const AT*)a, (const float*)s, group, qmax, (const BT*)b, M, N, D,
          lim, per, splits, a_vec, b_vec, s8, t, o, (int32_t*)ws,
          (int32_t*)cnt);
      return (int)cudaGetLastError();
    };
    if constexpr (RES)
      return go(rns_encode_residues_kernel<BT, K, BM, BN>, (int32_t*)out);
    else
      return go(rns_fused_mma_kernel<AT, BT, K, BM, BN>, (float*)out);
  }
}

// Every profile's digit count; int32 b residues belong to the profile that
// is not int8-safe (rns8_u8, K = 8), whose a residues are int32 too.
template <typename AT, int BM, int BN, bool RES = false>
static int launch_k(const void* a, const void* s, long long group,
                    float qmax, const void* b, int b_int8, int M, int N,
                    int D, int lim, int splits, const RnsTables& t, void* out,
                    void* ws, void* cnt, cudaStream_t st) {
  if (!b_int8) {
    if constexpr (sizeof(AT) == 1) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (t.K != 8) return (int)cudaErrorInvalidValue;
      return launch<AT, int32_t, 8, BM, BN, RES>(a, s, group, qmax, b, M, N,
                                                 D, lim, splits, t, out, ws,
                                                 cnt, st);
    }
  }
#define RNS_FUSED_MMA_CASE(k)                                             \
  case k:                                                                 \
    return launch<AT, int8_t, k, BM, BN, RES>(a, s, group, qmax, b, M, N, \
                                              D, lim, splits, t, out, ws,   \
                                              cnt, st);
  switch (t.K) {
    RNS_FUSED_MMA_CASE(5) RNS_FUSED_MMA_CASE(6) RNS_FUSED_MMA_CASE(7)
    RNS_FUSED_MMA_CASE(8) RNS_FUSED_MMA_CASE(9) RNS_FUSED_MMA_CASE(12)
    RNS_FUSED_MMA_CASE(16) RNS_FUSED_MMA_CASE(18) RNS_FUSED_MMA_CASE(21)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNS_FUSED_MMA_CASE
}

// Calls f(bm, bn) with the compiled tile (analysis/kernel_audit.py
// FUSED_MMA_TILES) as std::integral_constants.
template <typename F>
static int with_tile(int bm, int bn, F&& f) {
#define RNS_FUSED_MMA_TILE(m, n)                                \
  if (bm == m && bn == n)                                       \
    return f(std::integral_constant<int, m>{},                  \
             std::integral_constant<int, n>{});
  RNS_FUSED_MMA_TILE(16, 32) RNS_FUSED_MMA_TILE(16, 64)
  RNS_FUSED_MMA_TILE(32, 32) RNS_FUSED_MMA_TILE(32, 64)
#undef RNS_FUSED_MMA_TILE
  return (int)cudaErrorInvalidValue;
}

// The entry points compile in four shares (kernels/build.py PARTS): with
// -DBUILD_PART=p only share p's entry point and the kernels it
// instantiates are compiled, so four nvcc processes build the library's
// four disjoint sets of instantiations at once and one link joins them.
// Without BUILD_PART the file compiles whole.
#ifndef BUILD_PART
#define BUILD_PART -1
#endif
#define IN_PART(p) (BUILD_PART < 0 || BUILD_PART == (p))

// x [M, D] float32; s [M / group] float32, one scale per run of `group`
// rows; b [K, D, N] int8 (b_int8) or int32; out [M, N] float32,
// unscaled.  (bm, bn) one of the compiled tiles.  splits > 1 shares each
// tile's K steps among that many blocks and needs ws (int32, tiles *
// splits * K * bm * bn) and cnt (int32, one per tile, zero); the kernel
// leaves cnt zero.
#if IN_PART(0)
extern "C" int rns_fused_dot(const void* x, const void* s, long long group,
                             float qmax, const void* b, int b_int8, int M,
                             int N, int D, int lim, const RnsTables* t,
                             void* out, int bm, int bn, int splits, void* ws,
                             void* cnt, void* stream) {
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    return launch_k<float, decltype(tm)::value, decltype(tn)::value>(
        x, s, group, qmax, b, b_int8, M, N, D, lim, splits, *t, out, ws, cnt,
        (cudaStream_t)stream);
  });
}
#endif

// rns_fused_matmul_normalize for int8 a residues (share 1) and int32 ones
// (share 2).
template <typename AT>
static int matmul_normalize_as(const void* a, const void* b, int b_int8,
                               int M, int N, int D, int lim,
                               const RnsTables* t, void* out, int bm, int bn,
                               int splits, void* ws, void* cnt,
                               cudaStream_t st) {
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    return launch_k<AT, decltype(tm)::value, decltype(tn)::value>(
        a, nullptr, 1, 0.f, b, b_int8, M, N, D, lim, splits, *t, out, ws,
        cnt, st);
  });
}
int rns_fused_matmul_normalize_i8(const void* a, const void* b, int b_int8,
                                  int M, int N, int D, int lim,
                                  const RnsTables* t, void* out, int bm,
                                  int bn, int splits, void* ws, void* cnt,
                                  cudaStream_t st);
int rns_fused_matmul_normalize_i32(const void* a, const void* b, int b_int8,
                                   int M, int N, int D, int lim,
                                   const RnsTables* t, void* out, int bm,
                                   int bn, int splits, void* ws, void* cnt,
                                   cudaStream_t st);
#if IN_PART(1)
int rns_fused_matmul_normalize_i8(const void* a, const void* b, int b_int8,
                                  int M, int N, int D, int lim,
                                  const RnsTables* t, void* out, int bm,
                                  int bn, int splits, void* ws, void* cnt,
                                  cudaStream_t st) {
  return matmul_normalize_as<int8_t>(a, b, b_int8, M, N, D, lim, t, out, bm,
                                     bn, splits, ws, cnt, st);
}
#endif
#if IN_PART(2)
int rns_fused_matmul_normalize_i32(const void* a, const void* b, int b_int8,
                                   int M, int N, int D, int lim,
                                   const RnsTables* t, void* out, int bm,
                                   int bn, int splits, void* ws, void* cnt,
                                   cudaStream_t st) {
  return matmul_normalize_as<int32_t>(a, b, b_int8, M, N, D, lim, t, out, bm,
                                      bn, splits, ws, cnt, st);
}
#endif

// a [K, M, D] int8 (a_int8) or int32 residues; b, out, tiles and
// workspace as above.
#if IN_PART(1)
extern "C" int rns_fused_matmul_normalize(const void* a, int a_int8,
                                          const void* b, int b_int8, int M,
                                          int N, int D, int lim,
                                          const RnsTables* t, void* out,
                                          int bm, int bn, int splits,
                                          void* ws, void* cnt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a_int8)
    return rns_fused_matmul_normalize_i8(a, b, b_int8, M, N, D, lim, t, out,
                                         bm, bn, splits, ws, cnt, st);
  return rns_fused_matmul_normalize_i32(a, b, b_int8, M, N, D, lim, t, out,
                                        bm, bn, splits, ws, cnt, st);
}
#endif

// The fused encode + matmul: as rns_fused_dot, with out [K, M, N] int32
// residues.
#if IN_PART(3)
extern "C" int rns_fused_encode_matmul(const void* x, const void* s,
                                       long long group, float qmax,
                                       const void* b, int b_int8, int M,
                                       int N, int D, int lim,
                                       const RnsTables* t, void* out, int bm,
                                       int bn, int splits, void* ws,
                                       void* cnt, void* stream) {
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    return launch_k<float, decltype(tm)::value, decltype(tn)::value, true>(
        x, s, group, qmax, b, b_int8, M, N, D, lim, splits, *t, out, ws, cnt,
        (cudaStream_t)stream);
  });
}
#endif
