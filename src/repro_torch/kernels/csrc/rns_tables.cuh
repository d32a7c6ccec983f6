// Constant tables of one RNS profile, passed to a kernel BY VALUE (1348
// bytes of kernel parameters), so no fixed pool of __constant__ slots caps
// how many profiles one process can use.  Mirrors RnsTablesC in
// kernels/build.py.
#pragma once

#define RNS_MAX_K 21
// the MRC's pairs i < j, packed row by row: (i, j) -> RNS_PAIR(i, j)
#define RNS_PAIRS (RNS_MAX_K * (RNS_MAX_K - 1) / 2)
#define RNS_PAIR(i, j) ((i) * (2 * RNS_MAX_K - (i) - 1) / 2 + (j) - (i) - 1)

struct RnsTables {
  int K;
  int moduli[RNS_MAX_K];
  int half[RNS_MAX_K];              // MRC digits of M/2 (sign threshold)
  float w[RNS_MAX_K];               // float32(W_j), W_j = prod_{i<j} m_i
  unsigned magic[RNS_MAX_K];        // floor((2^32 - 1) / m_j), mulhi_mod
  int moff[RNS_MAX_K];              // m_j * ceil(2^16 / m_j) >= 65536,
                                    // for quant_residue
  unsigned mrc_c[RNS_PAIRS];        // ceil(2^32 / m_j) * inv_ij mod 2^32,
                                    // at RNS_PAIR(i, j): mrc_term
  int roff[RNS_MAX_K];              // m_j * ceil(256 / m_j) >= 256
};

// floor-mod for m > 0 (C's % truncates toward zero)
__device__ __forceinline__ int floor_mod(int v, int m) {
  int r = v % m;
  return r < 0 ? r + m : r;
}

// x mod m for 0 <= x < 2^31 and 2 <= m <= 256, with magic =
// floor((2^32 - 1) / m): a multiply-high gives floor(x / m) or one less,
// and one correction fixes it -- the same integer as floor_mod
__device__ __forceinline__ int mulhi_mod(int x, int m, unsigned magic) {
  const unsigned q = __umulhi((unsigned)x, magic);
  const int r = x - (int)q * m;
  return r >= m ? r - m : r;
}

// floor-mod of a signed accumulator, |x| < 2^31
__device__ __forceinline__ int signed_mod(int x, int m, unsigned magic) {
  if (x >= 0) return mulhi_mod(x, m, magic);
  const int r = mulhi_mod(-x, m, magic);
  return r ? m - r : 0;
}

// floor-mod of a quantized value v by digit j: while |v| <= 65535
// (NARROW: qmax <= 65535, bits <= 17) the offset moff_j, a multiple of
// m_j of at least 65536, makes it non-negative for mulhi_mod; wider
// values take floor_mod's division
template <bool NARROW>
__device__ __forceinline__ int quant_residue(int v, int j,
                                             const RnsTables& t) {
  return NARROW ? mulhi_mod(v + t.moff[j], t.moduli[j], t.magic[j])
                : floor_mod(v, t.moduli[j]);
}
