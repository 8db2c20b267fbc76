// cavlc_est.cuh — the CAVLC bit estimate of the encoder's RD decisions
// (avc/cavlc_dev.py block_bits_est) for one block, in one thread.
//
// The plain version works on whole tensors: it sorts each block's levels by
// scan rank (nonzero positions first, then zero positions, each in scan
// order) and takes cumulative sums over the ranks.  Here one thread walks
// the block's n levels in a few unrolled passes instead, and every term is
// the same integer as the plain version's:
// - rank rho of a nonzero is the count of nonzeros below it, and its
//   reverse rank total-1-rho the count above it (coding order runs from the
//   highest position down);
// - the plain version's run sums run over all n ranks, the zero positions'
//   ranks included, so run_above(rho) = rsum[n-1] - rsum[rho] telescopes to
//   pend + 1 - n - pos(rho) + rho, where pend is the position of rank n-1
//   (the largest zero position, or n-1 when every level is nonzero).
// Chroma DC blocks (N = 4) take their own coeff_token and total_zeros
// tables, as the plain version's chroma_dc=True does.

#pragma once

namespace cavlc {

// coeff_token lengths [nC class 0..2][TrailingOnes][TotalCoeff] (Table 9-5;
// class 3, nC >= 8, is a 6-bit FLC), entropy/cavlc.py COEFF_TOKEN_LEN
__constant__ int TOKEN_LEN[3][4][17] = {
    {{1, 6, 8, 9, 10, 11, 13, 13, 13, 14, 14, 15, 15, 16, 16, 16, 16},
     {0, 2, 6, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 15, 16, 16, 16},
     {0, 0, 3, 7, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 16, 16, 16},
     {0, 0, 0, 5, 6, 7, 8, 9, 10, 11, 13, 14, 14, 15, 15, 16, 16}},
    {{2, 6, 6, 7, 8, 8, 9, 11, 11, 12, 12, 12, 13, 13, 13, 14, 14},
     {0, 2, 5, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 14, 14, 14},
     {0, 0, 3, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 13, 14, 14},
     {0, 0, 0, 4, 4, 5, 6, 6, 7, 9, 11, 11, 12, 13, 13, 13, 14}},
    {{4, 6, 6, 6, 7, 7, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10},
     {0, 4, 5, 5, 5, 5, 6, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10},
     {0, 0, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10},
     {0, 0, 0, 4, 4, 4, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 10}}};

// total_zeros lengths [TotalCoeff - 1][total_zeros] (Table 9-7),
// entropy/cavlc.py TOTAL_ZEROS_LEN
__constant__ int TZ_LEN[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0},
    {6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0},
    {6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0},
    {5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

// run_before lengths [min(zerosLeft, 7) - 1][run_before] (Table 9-10),
// entropy/cavlc.py RUN_BEFORE_LEN
__constant__ int RB_LEN[7][16] = {
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0}};

// chroma DC coeff_token lengths [TrailingOnes][TotalCoeff] (Table 9-5,
// nC = -1), avc/tables.py CHROMA_DC_TOKEN_LEN
__constant__ int CDC_TOKEN_LEN[4][5] = {{2, 6, 6, 6, 6},
                                        {0, 1, 6, 7, 8},
                                        {0, 0, 3, 7, 8},
                                        {0, 0, 0, 6, 7}};

// chroma DC total_zeros lengths [TotalCoeff - 1][total_zeros] (Table
// 9-9a), avc/tables.py CHROMA_DC_TZ_LEN
__constant__ int CDC_TZ_LEN[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// floor(log2(x)) + 1 for x >= 1, 0 for x <= 0 (cavlc_dev.bitlen)
__device__ __forceinline__ int bitlen(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}

// Length of one level code, labs >= 1 (cavlc_dev._level_len).
__device__ __forceinline__ int level_len(int labs, int sign, int vlcnum) {
  if (vlcnum == 0) {
    return labs < 8 ? 2 * labs - 1 + sign
         : labs < 16 ? 19
         : 28 + 2 * max(bitlen(labs + 2032) - 12, 0);
  }
  const int shift = vlcnum - 1;
  const int escape = 15 << shift;
  const int labn = labs - 1;
  if (labn < escape) return (labn >> shift) + 1 + vlcnum;
  return 28 + 2 * max(bitlen(max(labn - escape + 2048, 1)) - 12, 0);
}

// Estimated bits of one block of N zig-zag levels zz[0..N-1] (N = max_coeff,
// 15 or 16) at nC nc: cavlc_dev.block_bits_est(zz, nc, N); with CHROMA_DC
// (N = 4) of a chroma DC block, whose nC is not read:
// cavlc_dev.block_bits_est(zz, 0, 4, chroma_dc=True).
template <int N, bool CHROMA_DC = false>
__device__ int block_bits_est(const int* zz, int nc) {
  int v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = zz[i];

  // total, the last nonzero position and the rank n-1 position
  int total = 0, last_pos = -1, zmax = -1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (v[i] != 0) {
      ++total;
      last_pos = i;
    } else {
      zmax = i;
    }
  }
  const int tz = last_pos + 1 - total;
  const int pend = total < N ? zmax : N - 1;

  // trailing ones: reverse rank of the highest level that is not +-1
  int m = N, rev = 0;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    if (v[i] != 0) {
      if (abs(v[i]) != 1 && m == N) m = rev;
      ++rev;
    }
  }
  const int t1 = min(min(m, 3), total);

  const int vt = nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
  int bits = (CHROMA_DC ? CDC_TOKEN_LEN[t1][total]
              : vt == 3 ? 6 : TOKEN_LEN[vt][t1][total]) + t1;

  // levels in coding order: the first coded level has reverse rank t1
  const int init = (total > 10 && t1 < 3) ? 1 : 0;
  const bool lth = !(total > 3 && t1 == 3);
  bool first_big = false;
  int big_seen = 0;   // coded levels above this one with |level| > 3
  rev = 0;
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    if (v[i] == 0) continue;
    const int labs = abs(v[i]);
    const int sign = v[i] < 0 ? 1 : 0;
    if (rev == t1) {                          // the first coded level
      first_big = labs > 3;
      const int adj = lth ? max(labs - 1, 1) : labs;
      bits += level_len(max(adj, 1), sign, clamp_int(init, 0, 6));
    } else if (rev > t1) {
      const int first_inc = init == 0 ? 1 : (first_big ? 1 : 0);
      int vlc = init + first_inc + big_seen - (first_big ? 1 : 0);
      if (first_big) vlc = max(vlc, 2);
      bits += level_len(labs, sign, clamp_int(vlc, 0, 6));
    }
    if (rev >= t1 && labs > 3) ++big_seen;
    ++rev;
  }

  if (total > 0 && total < N)
    bits += CHROMA_DC
        ? CDC_TZ_LEN[clamp_int(total - 1, 0, 2)][clamp_int(tz, 0, 3)]
        : TZ_LEN[clamp_int(total - 1, 0, 14)][clamp_int(tz, 0, 15)];

  // run_before of ranks 1..total-1, from the telescoped zerosLeft
  int rho = 0, prev = -1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (v[i] == 0) continue;
    if (rho >= 1 && rho <= total - 1) {
      const int zl = tz - (pend + 1 - N - i + rho);
      if (zl > 0)
        bits += RB_LEN[clamp_int(zl - 1, 0, 6)][clamp_int(i - prev - 1, 0, 15)];
    }
    prev = i;
    ++rho;
  }
  return bits;
}

}  // namespace cavlc
