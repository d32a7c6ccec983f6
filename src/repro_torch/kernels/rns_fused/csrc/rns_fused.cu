// Fused convert -> digit matmul of one projection in one kernel, the
// activation residues and the per-digit accumulators kept on chip:
//
//   rns_fused_encode_matmul    x f32 [M,D] (+ row scales), b [K,D,N]
//                              -> [K,M,N] int32 residues
//
// It replaces the Pallas kernel rns_fused_encode_matmul_tiles of
// src/repro/kernels/rns_fused/kernel.py; see kernels/rns_fused/ops.py for
// the bound and design.  (The dot and the matmul + normalize run on the
// tensor cores, csrc/rns_fused_mma.cu.)  The first, simple design:
//
// * a block computes a BM x BN output tile for ALL K digits, one warp per
//   digit (block = 32 K threads), each lane one column and BM * BN / 32
//   rows, the int32 accumulators of its digit in registers -- not the TPU
//   kernel's [K, bm, bn] int32 scratch, which at its 128 x 128 tiles would
//   be 576 KiB for rns9;
// * D is walked in BK-deep tiles staged in shared memory: the quantized
//   activation tile once per block (the shared csrc/rns_quantize rule,
//   then floor-mod per warp's digit), each digit's b tile by its warp; the
//   next tile is loaded into registers while the current one is
//   multiplied; a modular reduction every lazy_chunk - 1 terms at most, as
//   rns_matmul.cu keeps it;
// * the epilogue writes the residues mod m.
// Rows, columns and depth past M, N, D are masked in the kernel: a masked
// activation quantizes to 0 and adds nothing mod m.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_quantize.cuh"
#include "rns_tables.cuh"

// BK is fixed; the BM x BN output tile is a template parameter, one
// instantiation per compiled tile (analysis/kernel_audit.py FUSED_TILES),
// chosen at launch by the entry's bm, bn.
constexpr int BK = 32;
constexpr int NX = 2;               // x elements per thread per tile
constexpr size_t kMaxStaticShmem = 48 * 1024;

// x float32 [M,D], quantized in the prologue; BT: int8/int32 residues
// [K,D,N]; out [K,M,N] int32.  Lane = (row group h, column c).
template <typename BT, int BM, int BN>
__global__ void __launch_bounds__(RNS_MAX_K * 32)
rns_fused_kernel(const float* __restrict__ a, const float* __restrict__ s,
                 long long group, float qmax, const BT* __restrict__ b,
                 int M, int N, int D, int lim,
                 const __grid_constant__ RnsTables t,
                 int32_t* __restrict__ out) {
  // a lane is (row group h, column c): BN columns, 32 / BN row groups of
  // RPL rows
  static_assert(32 % BN == 0 && BM % (32 / BN) == 0 && BN <= BK,
                "tile must split over a warp's lanes");
  constexpr int RPL = BM * BN / 32;   // output rows per lane (4 at 8 x 16)
  constexpr int NB = BK * BN / 32;    // b residues per lane per tile
  constexpr int NA = BM * BK / 32;    // a residues per lane per tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = t.K;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % BN, h = lane / BN;
  const int m = t.moduli[w];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  int* Vs = (int*)smem;                       // [BK][BM] quantized x
  int* As = Vs + BK * BM;                     // [K][BK][BM] a residues
  BT* Bs = (BT*)(As + K * BK * BM);           // [K][BK][BN] b residues
  int* myA = As + w * BK * BM;
  BT* myB = Bs + w * BK * BN;
  const BT* Bw = b + (long long)w * D * N;

  // the next K tile is loaded into registers while this one is multiplied
  BT breg[NB];
  float xreg[NX], sreg[NX];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = lane + 32 * i, r = e / BN, cc = e % BN;
      const int gk = k0 + r, gn = col0 + cc;  // coalesced along n
      breg[i] = (gk < D && gn < N) ? Bw[(long long)gk * N + gn] : (BT)0;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = threadIdx.x + i * blockDim.x, r = e / BK, cc = e % BK;
      const int gm = row0 + r, gk = k0 + cc;  // coalesced along k
      const bool in = e < BM * BK && gm < M && gk < D;
      xreg[i] = in ? a[(long long)gm * D + gk] : 0.f;
      sreg[i] = in ? s[gm / group] : 0.f;
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
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      if (e < BM * BK)              // masked elements quantize to 0
        Vs[(e % BK) * BM + e / BK] = quantize_rn(xreg[i], sreg[i], qmax);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NA; ++i)
      myA[lane + 32 * i] = floor_mod(Vs[lane + 32 * i], m);
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
    __syncthreads();                // and so is Vs
    since += BK;
    if (since + BK > lim) {         // the next tile could overflow int32
#pragma unroll
      for (int r = 0; r < RPL; ++r) acc[r] %= m;
      since = 0;
    }
  }
  const int gn = col0 + c;
  int32_t* O = out + (long long)w * M * N;
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int gm = row0 + h * RPL + r;
    if (gm < M && gn < N) O[(long long)gm * N + gn] = acc[r] % m;  // >= 0
  }
}

template <typename BT, int BM, int BN>
static int launch(const void* a, const void* s, long long group, float qmax,
                  const void* b, int M, int N, int D, int lim,
                  const RnsTables& t, void* out, cudaStream_t st) {
  const int K = t.K;
  // a block of 32 K threads must cover the x tile in NX passes
  if (32 * K * NX < BM * BK || K > RNS_MAX_K) return cudaErrorInvalidValue;
  const size_t shmem = BK * BM * sizeof(int) +
                       (size_t)K * BK * BM * sizeof(int) +
                       (size_t)K * BK * BN * sizeof(BT);
  if (shmem > kMaxStaticShmem) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  rns_fused_kernel<BT, BM, BN><<<grid, 32 * K, shmem, st>>>(
      (const float*)a, (const float*)s, group, qmax, (const BT*)b, M, N, D,
      lim, t, (int32_t*)out);
  return (int)cudaGetLastError();
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
#define RNS_FUSED_TILE(m, n)                                              \
  if (bm == m && bn == n)                                                 \
    return b_int8 ? launch<int8_t, m, n>(x, s, group, qmax, b, M, N, D,   \
                                         lim, *t, out, st)                \
                  : launch<int32_t, m, n>(x, s, group, qmax, b, M, N, D,  \
                                          lim, *t, out, st);
  RNS_FUSED_TILE(8, 16) RNS_FUSED_TILE(8, 32) RNS_FUSED_TILE(16, 16)
#undef RNS_FUSED_TILE
  return cudaErrorInvalidValue;
}
