// avc_block.cuh — the 4x4 block arithmetic that the AVC decision scan's
// kernels share (intra4.cu, inter_rd.cu): the forward and inverse integer
// transforms, the quantiser with its CAVLC level clamp, the weighted
// dequantiser, the zig-zag order, the adaptive rounding adjustment and the
// RD cost's rounding.  Each function is one coefficient's or one pixel's
// share of avc/quant_dev.py and ops/transform.py, in their int32
// arithmetic.

#pragma once

namespace avc4 {

constexpr int LEVEL_LIMIT = 2063;     // the CAVLC level clamp
constexpr int AR_WEIGHT = 8;          // JM AdaptRndWeight
constexpr int OFFSET_INTER = 342;     // quant_dev.OFFSET_INTER (Q11)
constexpr float BIG = 1e18f;          // the cost of a candidate not allowed

// the zig-zag position of raster coefficient p (transform.ZIGZAG_INV)
__constant__ int ZZ_INV[16] = {0, 1, 5, 6, 2, 4, 7, 12,
                               3, 8, 11, 13, 9, 10, 14, 15};

// x + lam * y rounded once to float32 (device_enc._fma).  The product of a
// float32 lambda and a float32 integer is exact in float64, so a contracted
// multiply-add could not change it either.
__device__ __forceinline__ float rd_cost(double lam, int bits, int ssd) {
  const double a = (double)(float)ssd, b = (double)(float)bits;
  return __double2float_rn(__dadd_rn(a, __dmul_rn(lam, b)));
}

// Entry k of Cf v for the rows of Cf = [[1,1,1,1],[2,1,-1,-2],[1,-1,-1,1],
// [1,-2,2,-1]] (transform._fwd_stage)
__device__ __forceinline__ int fwd(int v0, int v1, int v2, int v3, int k) {
  const int s03 = v0 + v3, d03 = v0 - v3, s12 = v1 + v2, d12 = v1 - v2;
  return k == 0 ? s03 + s12 : k == 1 ? 2 * d03 + d12
       : k == 2 ? s03 - s12 : d03 - 2 * d12;
}

// Entry k of the JM inverse butterfly with >>1 (transform._inv_stage)
__device__ __forceinline__ int inv(int v0, int v1, int v2, int v3, int k) {
  const int a = v0 + v2, b = v0 - v2, c = (v1 >> 1) - v3, d = v1 + (v3 >> 1);
  return k == 0 ? a + d : k == 1 ? b + c : k == 2 ? b - c : a - d;
}

// Coefficient (r, c) of the forward transform Cf X Cf^T of the raster 4x4
// block x (transform.fdct4x4)
__device__ __forceinline__ int fdct_at(const int* x, int r, int c) {
  int u[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    u[a] = fwd(x[4 * a], x[4 * a + 1], x[4 * a + 2], x[4 * a + 3], c);
  return fwd(u[0], u[1], u[2], u[3], r);
}

// The inverse transform's row stage at (r, c) of the raster block d ...
__device__ __forceinline__ int idct_row(const int* d, int r, int c) {
  return inv(d[4 * r], d[4 * r + 1], d[4 * r + 2], d[4 * r + 3], c);
}

// ... and its column stage over the row stage's block x
__device__ __forceinline__ int idct_col(const int* x, int r, int c) {
  return inv(x[c], x[4 + c], x[8 + c], x[12 + c], r);
}

// clip(pred + (v + 32) >> 6, 0, 255) (transform.reconstruct)
__device__ __forceinline__ int recon(int pred, int v) {
  return min(max(pred + ((v + 32) >> 6), 0), 255);
}

// Signed level of coefficient w (quant_dev.quant4x4): mf the LevelScale at
// the position, off the rounding offset already shifted by 4 + per.
__device__ __forceinline__ int quant(int w, int mf, int off, int per) {
  const int l = min((abs(w) * mf + off) >> (15 + per), LEVEL_LIMIT);
  return w < 0 ? -l : w > 0 ? l : 0;
}

// Weighted dequantiser ((l * ils) << per + 8) >> 4 (quant_dev.dequant4x4);
// the flat one is this with ils = dequant_coef * 16.
__device__ __forceinline__ int dequant(int l, int ils, int per) {
  return (((l * ils) << per) + 8) >> 4;
}

// Adaptive rounding adjustment of one coefficient (quant_dev.ar_fadjust),
// in int32's wrap-around arithmetic as the plain version's tensors have it.
__device__ __forceinline__ int ar_adjust(int w, int l, int mf, int per) {
  const int la = abs(l), qbits = 15 + per;
  const unsigned scaled = (unsigned)(abs(w) * mf);
  const int adj = (int)((unsigned)AR_WEIGHT * (scaled - ((unsigned)la << qbits))
                        + (1u << qbits)) >> (qbits + 1);
  return (w != 0 && la != 0) ? adj : 0;
}

}  // namespace avc4
