// Fused residue datapath: the convert -> digit matmul -> MRC normalize
// chain of one projection in one kernel, with the activation residues and
// the per-digit accumulators kept on chip.  Three entry points:
//
//   rns_fused_encode_matmul    x f32 [M,D] (+ row scales), b [K,D,N]
//                              -> [K,M,N] int32 residues
//   rns_fused_matmul_normalize a [K,M,D] residues, b [K,D,N]
//                              -> [M,N] float32 (unscaled)
//   rns_fused_dot              x f32 [M,D] (+ row scales), b [K,D,N]
//                              -> [M,N] float32 (unscaled)
//
// They replace the Pallas kernels of src/repro/kernels/rns_fused/kernel.py
// (rns_fused_encode_matmul_tiles, rns_fused_matmul_normalize_tiles,
// rns_fused_dot_tiles); see kernels/rns_fused/ops.py for the bound and
// design.  One templated kernel serves all three:
//
// * a block computes a BM x BN output tile for ALL K digits, one warp per
//   digit (block = 32 K threads), each lane one column and BM * BN / 32
//   rows, the int32 accumulators of its digit in registers -- not the TPU
//   kernel's [K, bm, bn] int32 scratch, which at its 128 x 128 tiles would
//   be 576 KiB for rns9;
// * D is walked in BK-deep tiles staged in shared memory: the quantized
//   activation tile once per block (x input: the shared csrc/rns_quantize
//   rule, then floor-mod per warp's digit), each digit's b tile by its
//   warp; the next tile is loaded into registers while the current one is
//   multiplied; a modular reduction every lazy_chunk - 1 terms at most, as
//   rns_matmul.cu keeps it;
// * the epilogue writes residues (encode_matmul), or parks them in shared
//   memory (aliasing the operand tiles) and runs the MRC of
//   csrc/rns_mrc.cuh per output element (matmul_normalize, dot): the same
//   bits as core/mrc.decode_float.
// Rows, columns and depth past M, N, D are masked in the kernel: a masked
// activation quantizes to 0 and adds nothing mod m.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rns_mrc.cuh"
#include "rns_quantize.cuh"

// BK is fixed; the BM x BN output tile is a template parameter, one
// instantiation per compiled tile (analysis/kernel_audit.py FUSED_TILES),
// chosen at launch by the entries' bm, bn.
constexpr int BK = 32;
constexpr int NX = 2;               // x elements per thread per tile
constexpr size_t kMaxStaticShmem = 48 * 1024;

// AT: float (x, quantized in the prologue) or int8/int32 residues [K,M,D];
// BT: int8/int32 residues [K,D,N]; KT: 0 -> residues out, else the MRC
// epilogue over KT digits (KT == t.K).  Lane = (row group h, column c).
template <typename AT, typename BT, int KT, int BM, int BN>
__global__ void __launch_bounds__((KT ? KT : RNS_MAX_K) * 32)
rns_fused_kernel(const AT* __restrict__ a, const float* __restrict__ s,
                 long long group, float qmax, const BT* __restrict__ b,
                 int M, int N, int D, int lim,
                 const __grid_constant__ RnsTables t, void* __restrict__ out) {
  // a lane is (row group h, column c): BN columns, 32 / BN row groups of
  // RPL rows; the MRC epilogue's [K][BM][BN] residues alias As (BN <= BK)
  static_assert(32 % BN == 0 && BM % (32 / BN) == 0 && BN <= BK,
                "tile must split over a warp's lanes");
  constexpr int RPL = BM * BN / 32;   // output rows per lane (4 at 8 x 16)
  constexpr int NB = BK * BN / 32;    // b residues per lane per tile
  constexpr int NA = BM * BK / 32;    // a residues per lane per tile
  constexpr bool kQuant = std::is_same<AT, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = t.K;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % BN, h = lane / BN;
  const int m = t.moduli[w];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  int* Vs = (int*)smem;                       // [BK][BM] quantized x
  int* As = Vs + (kQuant ? BK * BM : 0);      // [K][BK][BM] a residues
  BT* Bs = (BT*)(As + K * BK * BM);           // [K][BK][BN] b residues
  int* myA = As + w * BK * BM;
  BT* myB = Bs + w * BK * BN;
  const BT* Bw = b + (long long)w * D * N;
  const AT* Aw = kQuant ? a : a + (long long)w * M * D;

  // the next K tile is loaded into registers while this one is multiplied
  BT breg[NB];
  int areg[NA];
  float xreg[NX], sreg[NX];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = lane + 32 * i, r = e / BN, cc = e % BN;
      const int gk = k0 + r, gn = col0 + cc;  // coalesced along n
      breg[i] = (gk < D && gn < N) ? Bw[(long long)gk * N + gn] : (BT)0;
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const int e = threadIdx.x + i * blockDim.x, r = e / BK, cc = e % BK;
        const int gm = row0 + r, gk = k0 + cc;  // coalesced along k
        const bool in = e < BM * BK && gm < M && gk < D;
        xreg[i] = in ? Aw[(long long)gm * D + gk] : 0.f;
        sreg[i] = in ? s[gm / group] : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int e = lane + 32 * i, r = e / BK, cc = e % BK;
        const int gm = row0 + r, gk = k0 + cc;  // coalesced along k
        areg[i] = (gm < M && gk < D) ? (int)Aw[(long long)gm * D + gk] : 0;
      }
    }
  };

  int acc[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) acc[r] = 0;
  int since = 0;                    // terms accumulated since a reduction
  load_tile(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < NB; ++i) myB[lane + 32 * i] = breg[i];
    if constexpr (kQuant) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const int e = threadIdx.x + i * blockDim.x;
        if (e < BM * BK)            // masked elements quantize to 0
          Vs[(e % BK) * BM + e / BK] = quantize_rn(xreg[i], sreg[i], qmax);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NA; ++i)
        myA[lane + 32 * i] = floor_mod(Vs[lane + 32 * i], m);
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int e = lane + 32 * i;
        myA[(e % BK) * BM + e / BK] = areg[i];
      }
    }
    __syncwarp();
    if (k0 + BK < D) load_tile(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const int bv = (int)myB[kk * BN + c];
#pragma unroll
      for (int r = 0; r < RPL; ++r)
        acc[r] += myA[kk * BM + h * RPL + r] * bv;
    }
    __syncwarp();                   // myA / myB are refilled next tile
    if constexpr (kQuant) __syncthreads();   // and so is Vs
    since += BK;
    if (since + BK > lim) {         // the next tile could overflow int32
#pragma unroll
      for (int r = 0; r < RPL; ++r) acc[r] %= m;
      since = 0;
    }
  }
  const int gn = col0 + c;
  if constexpr (KT == 0) {
    int32_t* O = (int32_t*)out + (long long)w * M * N;
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int gm = row0 + h * RPL + r;
      if (gm < M && gn < N) O[(long long)gm * N + gn] = acc[r] % m;  // >= 0
    }
  } else {
    int* Rs = As;                   // [K][BM][BN], aliases As / Bs
    __syncthreads();                // every warp is done with As / Bs
#pragma unroll
    for (int r = 0; r < RPL; ++r)
      Rs[(w * BM + h * RPL + r) * BN + c] = acc[r] % m;
    __syncthreads();
    float* O = (float*)out;
    for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
      const int r = e / BN, cc = e % BN;
      const int gm = row0 + r, gc = col0 + cc;
      if (gm >= M || gc >= N) continue;
      int res[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) res[j] = Rs[(j * BM + r) * BN + cc];
      O[(long long)gm * N + gc] = mrc_decode_float<KT>(res, t);
    }
  }
}

template <typename AT, typename BT, int KT, int BM, int BN>
static int launch(const void* a, const void* s, long long group, float qmax,
                  const void* b, int M, int N, int D, int lim,
                  const RnsTables& t, void* out, cudaStream_t st) {
  constexpr bool kQuant = std::is_same<AT, float>::value;
  const int K = t.K;
  // a block of 32 K threads must cover the x tile in NX passes
  if (32 * K * NX < BM * BK || K > RNS_MAX_K || (KT && KT != K))
    return cudaErrorInvalidValue;
  const size_t shmem = (kQuant ? BK * BM * sizeof(int) : 0) +
                       (size_t)K * BK * BM * sizeof(int) +
                       (size_t)K * BK * BN * sizeof(BT);
  if (shmem > kMaxStaticShmem) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  rns_fused_kernel<AT, BT, KT, BM, BN><<<grid, 32 * K, shmem, st>>>(
      (const AT*)a, (const float*)s, group, qmax, (const BT*)b, M, N, D, lim,
      t, out);
  return (int)cudaGetLastError();
}

// the MRC kernels' digit counts: every profile of core/moduli.PROFILES.
// int32 b residues belong to profiles that are not int8-safe (rns8_u8).
template <typename AT, int BM, int BN>
static int launch_mrc(const void* a, const void* s, long long group,
                      float qmax, const void* b, int b_int8, int M, int N,
                      int D, int lim, const RnsTables& t, void* out,
                      cudaStream_t st) {
  if (!b_int8) {
    if (t.K != 8) return cudaErrorInvalidValue;
    return launch<AT, int32_t, 8, BM, BN>(a, s, group, qmax, b, M, N, D, lim,
                                          t, out, st);
  }
#define RNS_FUSED_CASE(k)                                                   \
  case k:                                                                   \
    return launch<AT, int8_t, k, BM, BN>(a, s, group, qmax, b, M, N, D, \
                                         lim, t, out, st);
  switch (t.K) {
    RNS_FUSED_CASE(5) RNS_FUSED_CASE(6) RNS_FUSED_CASE(7) RNS_FUSED_CASE(8)
    RNS_FUSED_CASE(9) RNS_FUSED_CASE(12) RNS_FUSED_CASE(16)
    RNS_FUSED_CASE(18) RNS_FUSED_CASE(21)
    default: return cudaErrorInvalidValue;
  }
#undef RNS_FUSED_CASE
}

// Calls f(bm, bn) with the compiled tile as std::integral_constants.
template <typename F>
static int with_tile(int bm, int bn, F&& f) {
#define RNS_FUSED_TILE(m, n)                                    \
  if (bm == m && bn == n)                                       \
    return f(std::integral_constant<int, m>{},                  \
             std::integral_constant<int, n>{});
  RNS_FUSED_TILE(8, 16) RNS_FUSED_TILE(8, 32) RNS_FUSED_TILE(16, 16)
#undef RNS_FUSED_TILE
  return cudaErrorInvalidValue;
}

// x [M, D] float32; s [M / group] float32, one scale per run of `group`
// rows; b [K, D, N] int8 (b_int8) or int32; out [K, M, N] int32; (bm, bn)
// one of the compiled tiles.
extern "C" int rns_fused_encode_matmul(const void* x, const void* s,
                                       long long group, float qmax,
                                       const void* b, int b_int8, int M,
                                       int N, int D, int lim,
                                       const RnsTables* t, void* out, int bm,
                                       int bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    constexpr int TBM = decltype(tm)::value, TBN = decltype(tn)::value;
    if (b_int8)
      return launch<float, int8_t, 0, TBM, TBN>(x, s, group, qmax, b, M, N,
                                                D, lim, *t, out, st);
    return launch<float, int32_t, 0, TBM, TBN>(x, s, group, qmax, b, M, N, D,
                                               lim, *t, out, st);
  });
}

// x, s, b as above; out [M, N] float32, unscaled.
extern "C" int rns_fused_dot(const void* x, const void* s, long long group,
                             float qmax, const void* b, int b_int8, int M,
                             int N, int D, int lim, const RnsTables* t,
                             void* out, int bm, int bn, void* stream) {
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    return launch_mrc<float, decltype(tm)::value, decltype(tn)::value>(
        x, s, group, qmax, b, b_int8, M, N, D, lim, *t, out,
        (cudaStream_t)stream);
  });
}

// a [K, M, D] int8 (a_int8) or int32 residues; b as above; out [M, N]
// float32, unscaled.
extern "C" int rns_fused_matmul_normalize(const void* a, int a_int8,
                                          const void* b, int b_int8, int M,
                                          int N, int D, int lim,
                                          const RnsTables* t, void* out,
                                          int bm, int bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return with_tile(bm, bn, [&](auto tm, auto tn) {
    constexpr int TBM = decltype(tm)::value, TBN = decltype(tn)::value;
    if (a_int8)
      return launch_mrc<int8_t, TBM, TBN>(a, nullptr, 1, 0.f, b, b_int8, M,
                                          N, D, lim, *t, out, st);
    return launch_mrc<int32_t, TBM, TBN>(a, nullptr, 1, 0.f, b, b_int8, M, N,
                                         D, lim, *t, out, st);
  });
}
