// intra4.cu — the intra 4x4 sub-scan of the AVC decision scan
// (avc/device_enc.py _eval_i4) for every lane of one wavefront step.
//
// Replaces no Pallas kernel: it mirrors h264tpu/avc/tpu_enc.py:592 _eval_i4,
// which XLA runs on the TPU as a scan over the 16 blocks.  The port's plain
// version is the same loop in PyTorch: ~8 000 small ops a step, each on a
// few hundred elements, about half of the launches of the step's CUDA graph
// in P and B pictures alike.  This kernel does the sub-scan in one launch.
//
// The sub-scan.  For each lane (one MB per MB row of the picture), the 16
// 4x4 blocks in coding order each predict from the reconstruction of the
// blocks before them: the 9 predictions with their availability, the most
// probable mode, nC from the left and top nonzero counts, transform, the
// quantiser with the lane's adaptive rounding offsets and the CAVLC level
// clamp, zig-zag, dequantiser, inverse transform, reconstruction, SSD, the
// mode bits plus the CAVLC estimate (cavlc_est.cuh), the RD cost, and the
// first minimum of the 9 costs, whose reconstruction goes into the patch
// that the next block predicts from.  Every step is the plain version's
// int32 arithmetic; the RD costs round as device_enc._fma does: float32 SSD
// plus float64 lambda times float32 bits in float64, narrowed once.
//
// What bounds it: latency, not bytes.  A lane reads ~2.9 KB and writes
// ~2.4 KB; at L = 18 lanes that is ~30 ns of the card's bandwidth.  But the
// 16 blocks are a dependency chain: each reads the reconstruction that the
// block before it chose.  The state between blocks is ~2 KB a lane.
//
// What the design does about that.
// - One thread block per lane, and everything stays in shared memory for
//   the whole sub-scan: the 17x25 reconstruction patch, the 16x16 original,
//   the lane's quantiser tables at its QP, the MB's modes and nonzero
//   counts.  Device memory is read once at the start and written once at
//   the end.
// - 9 modes x 16 positions = 144 threads: thread (m, p) predicts, transforms,
//   quantises, reconstructs and squares pixel p of mode m, so the 9 modes of
//   a block run side by side.  Between the phases of a block the threads
//   meet at __syncthreads; a block's bit estimates run one thread per mode.
// - Per-lane QP, lambda and rounding offsets, and the weighted scaling
//   tables (the flat ones when no scaling matrix is on), are inputs: rate
//   control's per-slice QPs, the B pyramid's QP cascade and High profile's
//   default lists all take this one path.

#include <cuda_runtime.h>

#include "avc_block.cuh"
#include "cavlc_est.cuh"

namespace {

using namespace avc4;

constexpr int MODES = 9;
constexpr int THREADS = MODES * 16;   // one thread per (mode, pixel)
constexpr int PW = 25;                // the patch is 17 x 25: row 0 and
constexpr int PATCH = 17 * PW;        // column 0 are the neighbours

// the blocks in coding order (tables.BLOCK_SCAN), and whether block k's
// top-right neighbour inside the MB is coded before it (_TR_INMB_OK)
__constant__ int SCAN_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int SCAN_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int TR_INMB_OK[16] = {0, 0, 1, 0, 0, 0, 1, 0,
                                   1, 1, 1, 0, 1, 0, 1, 0};

struct In {
  const int* patch;        // [L, 17, 25] reconstruction around the MB
  const int* org;          // [L, 16, 16]
  const long long* mby;    // [L] band-local MB row
  const long long* mbx;    // [L] MB column
  const int* l_nnz;        // [L, 4] counts left of the MB
  const int* t_nnz;        // [L, 4] counts above it
  const int* l_i4m;        // [L, 4] intra 4x4 modes left of the MB
  const int* t_i4m;        // [L, 4] ... above it
  const int* qp;           // [L]
  const double* lam;       // [L]
  const int* ar_off;       // [L, 4, 4] adaptive rounding offsets (Q11)
  const int* mf;           // [6, 4, 4] LevelScale
  const int* ils;          // [6, 4, 4] InvLevelScale (x16 when flat)
  int mb_w;
};

struct Out {
  int* modes;              // [L, 16] in coding order
  int* zzs;                // [L, 16, 16] zig-zag levels in coding order
  int* flags;              // [L, 16, 2] prev_intra4x4_pred_mode, rem
  int* rec;                // [L, 16, 16]
  int* nnz_cells;          // [L, 4, 4] raster
  int* modes_cells;        // [L, 4, 4] raster
  int* fadj;               // [L, 4, 4]
  float* cost;             // [L]
};

// The 13 neighbours of a block as intra_dev.pred4x4_all orders them:
// s(0) the corner, s(1..8) the row above (5..8 replaced by s(4) without the
// top-right), s(9..12) the column to the left.
struct Nbr {
  const int* pat;
  int y, x;                // the block's top-left pixel in the patch
  bool tr;
  __device__ __forceinline__ int operator()(int i) const {
    if (i == 0) return pat[(y - 1) * PW + x - 1];
    if (i <= 8) return pat[(y - 1) * PW + x - 1 + (i > 4 && !tr ? 4 : i)];
    return pat[(y + i - 9) * PW + x - 1];
  }
};

__device__ __forceinline__ int top(int i) { return i < 0 ? 0 : 1 + i; }
__device__ __forceinline__ int left(int i) { return i < 0 ? 0 : 9 + i; }

// Pixel (r, c) of 4x4 prediction mode m (spec 8.3.1.2; the cases of
// intra_dev._build_i4_tables).
__device__ int pred_sample(int m, int r, int c, const Nbr& s, bool at,
                           bool al) {
  auto two = [&](int a, int b) { return (s(a) + s(b) + 1) >> 1; };
  auto three = [&](int a, int b, int d) {
    return (s(a) + 2 * s(b) + s(d) + 2) >> 2;
  };
  switch (m) {
    case 0:                                            // vertical
      return s(top(c));
    case 1:                                            // horizontal
      return s(left(r));
    case 2: {                                          // DC
      const int st = s(1) + s(2) + s(3) + s(4);
      const int sl = s(9) + s(10) + s(11) + s(12);
      return at && al ? (st + sl + 4) >> 3
           : at ? (st + 2) >> 2 : al ? (sl + 2) >> 2 : 128;
    }
    case 3: {                                          // diagonal down-left
      const int i = r + c;
      return i == 6 ? (s(top(6)) + 3 * s(top(7)) + 2) >> 2
                    : three(top(i), top(i + 1), top(i + 2));
    }
    case 4:                                            // diagonal down-right
      if (c > r) return three(top(c - r - 2), top(c - r - 1), top(c - r));
      if (c < r) return three(left(r - c - 2), left(r - c - 1), left(r - c));
      return three(top(0), 0, left(0));
    case 5: {                                          // vertical-right
      const int z = 2 * c - r, i = c - (r >> 1);
      if (z >= 0 && z % 2 == 0) return two(top(i - 1), top(i));
      if (z >= 0) return three(top(i - 2), top(i - 1), top(i));
      if (z == -1) return three(left(0), 0, top(0));
      const int j = r - 2 * c;
      return three(left(j - 1), left(j - 2), left(j - 3));
    }
    case 6: {                                          // horizontal-down
      const int z = 2 * r - c, i = r - (c >> 1);
      if (z >= 0 && z % 2 == 0) return two(left(i - 1), left(i));
      if (z >= 0) return three(left(i - 2), left(i - 1), left(i));
      if (z == -1) return three(top(0), 0, left(0));
      const int j = c - 2 * r;
      return three(top(j - 1), top(j - 2), top(j - 3));
    }
    case 7: {                                          // vertical-left
      const int i = c + (r >> 1);
      return r % 2 == 0 ? two(top(i), top(i + 1))
                        : three(top(i), top(i + 1), top(i + 2));
    }
    default: {                                         // horizontal-up
      const int z = c + 2 * r, i = r + (c >> 1);
      if (z > 5) return s(left(3));
      if (z == 5) return (s(left(2)) + 3 * s(left(3)) + 2) >> 2;
      if (z % 2 == 0) return two(left(i), left(i + 1));
      return three(left(i), left(i + 1), left(i + 2));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
intra4_kernel(In in, Out out) {
  __shared__ int pat[PATCH];
  __shared__ int org[256];
  __shared__ int mfq[16], ilsq[16], offq[16];   // the lane's tables at qp
  __shared__ int nbr_nnz[2][4], nbr_mode[2][4];  // left, top
  __shared__ int modes_c[16], nnz_c[16], fadj[16];
  __shared__ int pred[MODES][16], tmp[MODES][16], deq[MODES][16];
  __shared__ int wco[MODES][16], lev[MODES][16], zz[MODES][16];
  __shared__ int rec[MODES][16], sq[MODES][16];
  __shared__ float cost[MODES];
  __shared__ int ssd9[MODES], bits9[MODES], mpm_s;
  __shared__ int ssd_tot, bits_tot;

  const int lane = blockIdx.x, t = threadIdx.x;
  const int m = t >> 4, p = t & 15, r = p >> 2, c = p & 3;
  const int qp = in.qp[lane], per = qp / 6, rem = qp % 6;
  const long long mbx = in.mbx[lane];
  const bool has_l = mbx > 0, has_t = in.mby[lane] > 0;

  for (int i = t; i < PATCH; i += THREADS)
    pat[i] = in.patch[(long long)lane * PATCH + i];
  for (int i = t; i < 256; i += THREADS)
    org[i] = in.org[(long long)lane * 256 + i];
  if (t < 16) {
    mfq[t] = in.mf[rem * 16 + t];
    ilsq[t] = in.ils[rem * 16 + t];
    offq[t] = in.ar_off[lane * 16 + t] << (4 + per);
    fadj[t] = 0;
  } else if (t < 20) {
    const int i = t - 16;
    nbr_nnz[0][i] = in.l_nnz[lane * 4 + i];
    nbr_nnz[1][i] = in.t_nnz[lane * 4 + i];
    nbr_mode[0][i] = in.l_i4m[lane * 4 + i];
    nbr_mode[1][i] = in.t_i4m[lane * 4 + i];
  } else if (t == 20) {
    ssd_tot = 0;
    bits_tot = 0;
  }
  __syncthreads();

  for (int k = 0; k < 16; ++k) {
    const int y4 = SCAN_Y[k], x4 = SCAN_X[k];
    const bool at = y4 == 0 ? has_t : true;
    const bool al = x4 == 0 ? has_l : true;
    const bool tr = y4 == 0 ? (x4 < 3 ? has_t : has_t && mbx < in.mb_w - 1)
                            : (x4 < 3 && TR_INMB_OK[k]);
    const int oy = 4 * y4 + r, ox = 4 * x4 + c;       // pixel in the MB

    // prediction and residual of pixel (r, c) of mode m
    const Nbr s{pat, 1 + 4 * y4, 1 + 4 * x4, tr};
    const int pv = pred_sample(m, r, c, s, at, al);
    pred[m][p] = pv;
    tmp[m][p] = org[oy * 16 + ox] - pv;
    __syncthreads();

    // coefficient (r, c): Cf X Cf^T, then quantiser, zig-zag, dequantiser
    {
      const int w = fdct_at(tmp[m], r, c);
      const int lv = quant(w, mfq[p], offq[p], per);
      wco[m][p] = w;
      lev[m][p] = lv;
      zz[m][ZZ_INV[p]] = lv;
      deq[m][p] = dequant(lv, ilsq[p], per);
    }
    __syncthreads();

    // inverse transform: rows ...
    tmp[m][p] = idct_row(deq[m], r, c);
    __syncthreads();

    // ... then columns, reconstruction and squared error
    {
      const int rv = recon(pred[m][p], idct_col(tmp[m], r, c));
      const int e = org[oy * 16 + ox] - rv;
      rec[m][p] = rv;
      sq[m][p] = e * e;
    }
    __syncthreads();

    // one thread per mode: SSD, most probable mode, nC, bits, RD cost
    if (t < MODES) {
      int ssd = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) ssd += sq[t][i];
      int ma, na, mb, nb;
      if (x4 > 0) {
        ma = modes_c[y4 * 4 + x4 - 1];
        na = nnz_c[y4 * 4 + x4 - 1];
      } else {
        ma = has_l ? nbr_mode[0][y4] : -2;
        na = has_l ? nbr_nnz[0][y4] : 0;
      }
      if (y4 > 0) {
        mb = modes_c[(y4 - 1) * 4 + x4];
        nb = nnz_c[(y4 - 1) * 4 + x4];
      } else {
        mb = has_t ? nbr_mode[1][x4] : -2;
        nb = has_t ? nbr_nnz[1][x4] : 0;
      }
      const int mpm = (ma == -2 || mb == -2)
                          ? 2 : min(ma >= 0 ? ma : 2, mb >= 0 ? mb : 2);
      const int nc = al && at ? (na + nb + 1) >> 1 : al ? na : at ? nb : 0;
      const int bits = (t == mpm ? 1 : 4)
                       + cavlc::block_bits_est<16>(zz[t], nc);
      const bool allowed = t == 0 || t == 3 || t == 7 ? at
                         : t == 1 || t == 8 ? al
                         : t == 2 ? true : at && al;
      cost[t] = allowed ? rd_cost(in.lam[lane], bits, ssd) : BIG;
      ssd9[t] = ssd;
      bits9[t] = bits;
      if (t == 0) mpm_s = mpm;
    }
    __syncthreads();

    // the first minimum wins: its pixels go into the patch
    if (t < 16) {
      int best = 0;
#pragma unroll
      for (int i = 1; i < MODES; ++i)
        if (cost[i] < cost[best]) best = i;
      pat[(1 + 4 * y4 + r) * PW + 1 + 4 * x4 + c] = rec[best][p];
      out.zzs[((long long)lane * 16 + k) * 16 + p] = zz[best][p];
      // adaptive rounding adjustment (quant_dev.ar_fadjust)
      fadj[p] += ar_adjust(wco[best][p], lev[best][p], mfq[p], per);
      if (t == 0) {
        int nnz = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) nnz += zz[best][i] != 0;
        const int mpm = mpm_s;
        modes_c[y4 * 4 + x4] = best;
        nnz_c[y4 * 4 + x4] = nnz;
        ssd_tot += ssd9[best];
        bits_tot += bits9[best];
        out.modes[lane * 16 + k] = best;
        out.flags[(lane * 16 + k) * 2] = best == mpm;
        out.flags[(lane * 16 + k) * 2 + 1] = best - (best > mpm);
      }
    }
    __syncthreads();
  }

  for (int i = t; i < 256; i += THREADS)
    out.rec[lane * 256 + i] = pat[(1 + (i >> 4)) * PW + 1 + (i & 15)];
  if (t < 16) {
    out.nnz_cells[lane * 16 + t] = nnz_c[t];
    out.modes_cells[lane * 16 + t] = modes_c[t];
    out.fadj[lane * 16 + t] = fadj[t];
  }
  if (t == 0) out.cost[lane] = rd_cost(in.lam[lane], bits_tot, ssd_tot);
}

}  // namespace

extern "C" int intra4_launch(
    const void* patch, const void* org, const void* mby, const void* mbx,
    const void* l_nnz, const void* t_nnz, const void* l_i4m,
    const void* t_i4m, const void* qp, const void* lam, const void* ar_off,
    const void* mf, const void* ils, void* modes, void* zzs, void* flags,
    void* rec, void* nnz_cells, void* modes_cells, void* fadj, void* cost,
    int L, int mb_w, int device, void* stream) {
  if (L < 1 || mb_w < 1) return (int)cudaErrorInvalidValue;
  int prev = -1;                      // the caller's device, put back after
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const In in{static_cast<const int*>(patch), static_cast<const int*>(org),
              static_cast<const long long*>(mby),
              static_cast<const long long*>(mbx),
              static_cast<const int*>(l_nnz), static_cast<const int*>(t_nnz),
              static_cast<const int*>(l_i4m), static_cast<const int*>(t_i4m),
              static_cast<const int*>(qp), static_cast<const double*>(lam),
              static_cast<const int*>(ar_off), static_cast<const int*>(mf),
              static_cast<const int*>(ils), mb_w};
  const Out out{static_cast<int*>(modes), static_cast<int*>(zzs),
                static_cast<int*>(flags), static_cast<int*>(rec),
                static_cast<int*>(nnz_cells), static_cast<int*>(modes_cells),
                static_cast<int*>(fadj), static_cast<float*>(cost)};
  intra4_kernel<<<L, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(in,
                                                                      out);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
