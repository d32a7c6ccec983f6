// Digit-sliced modular matmul: out[s] = (a[s] @ b[s]) mod m_s.
// One block per (BN columns, BM rows, digit s = blockIdx.z); BK-deep tiles
// of a and b staged in shared memory; int32 accumulators in registers with
// a modular reduction every `lim` terms (lazy reduction: residues < m keep
// each product < (m-1)^2, and lim * (m-1)^2 + m <= 2^31 - 1).
// Replaces the Pallas kernel
// src/repro/kernels/rns_matmul/kernel.py:rns_matmul_tiles; see
// kernels/rns_matmul/ops.py for its bound and design.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_tables.cuh"

// BK and the block size are fixed; the (BM, BN) output tile is a template
// parameter, one instantiation per compiled tile (analysis/kernel_audit.py
// MATMUL_TILES), chosen at launch by rns_matmul's bm, bn.
constexpr int BK = 32, THREADS = 256;

template <typename InT, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
rns_matmul_kernel(const InT* __restrict__ a, const InT* __restrict__ b,
                  int M, int N, int D, int lim,
                  const __grid_constant__ RnsTables t,
                  int32_t* __restrict__ out) {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "a 16 x 16 thread grid");
  constexpr int TM = BM / 16, TN = BN / 16;   // outputs per thread: TM x TN
  const int s = blockIdx.z;
  const int m = t.moduli[s];
  const InT* A = a + (long long)s * M * D;
  const InT* B = b + (long long)s * D * N;
  int32_t* O = out + (long long)s * M * N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  __shared__ int As[BK][BM + 1];    // k-major; +1 breaks bank conflicts
  __shared__ int Bs[BK][BN];

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  int since = 0;                    // terms accumulated since a reduction
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {   // coalesced along k
      const int r = e / BK, c = e % BK;
      const int gm = row0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < D) ? (int)A[(long long)gm * D + gk] : 0;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {   // coalesced along n
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = col0 + c;
      Bs[r][c] = (gk < D && gn < N) ? (int)B[(long long)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
    since += BK;
    if (since + BK > lim) {         // the next tile could overflow int32
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] %= m;
      since = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn < N) O[(long long)gm * N + gn] = acc[i][j] % m;  // acc >= 0
    }
  }
}

template <int BM, int BN>
static int launch(const void* a, const void* b, int S, int M, int N, int D,
                  int lim, const RnsTables& t, void* out, int in_int8,
                  cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  if (in_int8) {
    rns_matmul_kernel<int8_t, BM, BN><<<grid, THREADS, 0, st>>>(
        (const int8_t*)a, (const int8_t*)b, M, N, D, lim, t, (int32_t*)out);
  } else {
    rns_matmul_kernel<int32_t, BM, BN><<<grid, THREADS, 0, st>>>(
        (const int32_t*)a, (const int32_t*)b, M, N, D, lim, t,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// a [S, M, D], b [S, D, N] residues (int8 if in_int8, else int32; all
// >= 0), out [S, M, N] int32.  lim = lazy_chunk - 1 >= BK; (bm, bn) one
// of the compiled tiles.
extern "C" int rns_matmul(const void* a, const void* b, int S, int M, int N,
                          int D, int lim, const RnsTables* t, void* out,
                          int in_int8, int bm, int bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lim < BK) return cudaErrorInvalidValue;
#define RNS_MATMUL_TILE(m, n)                                             \
  if (bm == m && bn == n)                                                 \
    return launch<m, n>(a, b, S, M, N, D, lim, *t, out, in_int8, st);
  RNS_MATMUL_TILE(32, 64) RNS_MATMUL_TILE(64, 64) RNS_MATMUL_TILE(32, 128)
#undef RNS_MATMUL_TILE
  return cudaErrorInvalidValue;
}
