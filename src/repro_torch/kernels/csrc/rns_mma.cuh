// Building blocks of the integer tensor-core kernels, shared by
// rns_matmul.cu (B.2, B.5) and rns_fused_mma.cu (B.4, B.6): 16-byte cp.async
// staging into a shared-memory ring, staging element by element with a
// narrowing to unsigned bytes, the u8 (and s8 x u8) MMA, and the 4 x 4
// byte transpose that turns N-contiguous b rows into the MMA's column
// operand.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// c += a (16 x 32 u8, row) . b (32 x 8 u8, col), int32 accumulators
__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the same with a's bytes signed (s8): c += a . b, a in [-128, 127]
__device__ __forceinline__ void mma_s8u8(int (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the low bytes of four 32-bit values, in order, as one word
__device__ __forceinline__ uint32_t low_bytes(int4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
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

// Stage NMAT tiles of R x C elements of T by 16-byte cp.async, NT
// threads sharing the copies: tile j comes from G + j * gmat (row-major,
// ld elements a row, rows < nr and columns < nc exist) at (r0, c0), and
// goes to S + j * smat (row stride sst bytes).  A 16-byte chunk past the
// edge is zero-filled, so the edge must fall on a chunk boundary (nc a
// multiple of 16 / sizeof(T), rows 16-byte aligned).
template <typename T, int R, int C, int NT, int NMAT = 1>
__device__ __forceinline__ void stage_async(uint8_t* S, int smat, int sst,
                                            const T* __restrict__ G,
                                            long long gmat, long long ld,
                                            int nr, int nc, int r0, int c0) {
  constexpr int EPC = 16 / (int)sizeof(T);     // elements a chunk
  constexpr int CH = C / EPC;                  // chunks a row
  static_assert(C % EPC == 0, "rows of whole 16-byte chunks");
  for (int c = threadIdx.x; c < NMAT * R * CH; c += NT) {
    const int j = c / (R * CH), rc = c % (R * CH);
    const int r = rc / CH, ch = rc % CH;
    const int gr = r0 + r, gc = c0 + EPC * ch;
    const bool ok = gr < nr && gc < nc;
    cp_async16(S + j * smat + r * sst + 16 * ch,
               ok ? (const void*)(G + j * gmat + (long long)gr * ld + gc)
                  : (const void*)G,
               ok ? 16 : 0);
  }
}

// The same tiles element by element, each converted to U (by default
// narrowed to an unsigned byte, residues being below 256) and stored at
// S + j * smat + r * sst + c * sizeof(U); elements past the edge are 0.
template <typename T, int R, int C, int NT, int NMAT = 1,
          typename U = uint8_t>
__device__ __forceinline__ void stage_elems(uint8_t* S, int smat, int sst,
                                            const T* __restrict__ G,
                                            long long gmat, long long ld,
                                            int nr, int nc, int r0, int c0) {
  for (int e = threadIdx.x; e < NMAT * R * C; e += NT) {
    const int j = e / (R * C), rc = e % (R * C);
    const int r = rc / C, c = rc % C;
    const int gr = r0 + r, gc = c0 + c;
    *(U*)(S + j * smat + r * sst + c * (int)sizeof(U)) =
        (gr < nr && gc < nc) ? (U)G[j * gmat + (long long)gr * ld + gc]
                             : (U)0;
  }
}
