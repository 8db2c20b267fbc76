// inter_rd.cu — the P picture's inter candidates of the AVC decision scan,
// with their residual coding and bit estimates (avc/device_enc.py
// _inter_rd), for every lane of one wavefront step.
//
// Replaces no Pallas kernel: it mirrors h264tpu/avc/tpu_enc.py's inter RD
// of a P macroblock, which XLA fuses on the TPU.  The port's plain version
// (_inter_rd_reference) is ~5 300 small PyTorch ops a step, ~60 % of the
// nodes of a P step's CUDA graph.  This kernel does it in one launch.
//
// What it computes, per lane (one MB per MB row of the picture):
// - per partition mode (16x16, 16x8, 8x16, 8x8) and list-0 reference, the
//   spec 8.4.1.3 median predictor of each partition, each seeing the ones
//   before it, the se(v) MVD and te(v) ref bits, the ME cost
//   sad + lambda_me * bits, and the first least cost over the references;
// - the 16x16 candidate at the median predictor with ref 0, and P_Skip's
//   motion vector (spec 8.4.1.1);
// - motion compensation of every candidate and of skip: luma a gather from
//   the phase-split quarter-pel planes, chroma the spec 8.4.2.2.2 bilinear
//   with explicit-WP weights when given; every window start is clamped to
//   the band's view as the plain version's gathers clamp it;
// - the residual coding of every candidate: the 4x4 transform, quantiser
//   with the lane's adaptive rounding offsets (luma) or 342 (chroma) and
//   the CAVLC level clamp, zig-zag, chroma DC Hadamard, dequantiser,
//   inverse transform and reconstruction, luma and chroma SSD, cbp and the
//   adaptive rounding adjustment;
// - the CAVLC estimates (cavlc_est.cuh) of the luma blocks at their nC,
//   the chroma AC blocks at nC 0 and the chroma DC blocks, the header and
//   cbp bits, and the RD cost ssd + lambda * bits; skip's cost ssd +
//   lambda.  Forced-intra lanes cost BIG.
// High profile's P_8x8 with sub-partitions enters as a sixth candidate
// whose prediction, header bits and reference are inputs (its search stays
// in PyTorch); its residual RD runs here with the others'.  Every step is
// the plain version's int32 arithmetic, and the costs round as
// device_enc._fma does.
//
// What bounds it: latency, not bytes.  A lane reads ~10 KB (windows of the
// reference planes, the original, the MV field around the MB) and writes
// ~25 KB; at L = 68 lanes that is ~0.7 us of the card's bandwidth.  The work
// of a candidate is a chain of dependent phases (prediction, transform,
// quantiser, the chroma DC, dequantiser, two inverse stages, bit counts),
// each of a few hundred independent pixels or coefficients.
//
// What the design does about that.
// - One thread block per (lane, candidate), and one more per lane for
//   skip: 18 x 6 blocks at CIF, 68 x 6 at 1080p, one to a few waves over
//   the 132 SMs.  The candidates' chains run side by side.
// - 384 threads: 256 luma pixels (coefficients) and 128 chroma ones, so
//   luma and chroma move through the phases together; the phases meet at
//   __syncthreads, and each thread keeps its own pixel's original,
//   prediction and level in registers from the first read to the last
//   write.  Blocks of coefficients, the lane's quantiser tables and the MV
//   cells around the MB sit in shared memory (~7 KB).
// - The reference choice of a partition mode runs one thread per
//   reference; the 16 luma, 8 chroma AC and 2 chroma DC bit estimates run
//   one thread each, in three warps so that their walks do not serialise.
// - Sums (SSD) reduce a warp at a time (__reduce_add_sync), then over the
//   12 warps.

#include <cuda_runtime.h>

#include "avc_block.cuh"
#include "cavlc_est.cuh"

namespace {

using namespace avc4;

constexpr int THREADS = 384;          // 256 luma pixels, then 128 chroma
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 16;             // list-0 references (num_ref_frames)

// the partition modes (device_enc.MODE_GEO4, MODE_SLOTS, MODE_HDR_BITS):
// the first slot, the number of partitions, the mb_type bits
__constant__ int FIRST_SLOT[4] = {0, 1, 3, 5};
__constant__ int N_PARTS[4] = {1, 2, 2, 4};
__constant__ int HDR_BITS[4] = {1, 3, 3, 9};
// slot geometry in 8x8 cells (device_enc.SLOTS): row, column, height, width
__constant__ int SLOT_GEO[9][4] = {{0, 0, 2, 2}, {0, 0, 1, 2}, {1, 0, 1, 2},
                                   {0, 0, 2, 1}, {0, 1, 2, 1}, {0, 0, 1, 1},
                                   {0, 1, 1, 1}, {1, 0, 1, 1}, {1, 1, 1, 1}};
// the directional prediction of a slot (device_enc.MODE_TAGS): 0 none, 1
// from A (16x8 bottom, 8x16 left), 2 from B (16x8 top), 3 from C (8x16
// right)
__constant__ int SLOT_DIR[9] = {0, 2, 1, 1, 3, 0, 0, 0, 0};
// the luma blocks in coding order (tables.BLOCK_SCAN), and the coding-order
// index of each raster block (tables.BLOCK_SCAN_INV)
__constant__ int SCAN_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ int SCAN_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ int SCAN_INV[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                 8, 9, 12, 13, 10, 11, 14, 15};
// codeNum of an inter coded_block_pattern (tables.CBP_TO_CODENUM_INTER)
__constant__ int CBP_INTER[48] = {
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12};

struct In {
  const int* st_mv;            // [S, sh4, w4, 2] the band MV field
  const int* st_ref;           // [S, sh4, w4] (-2: not coded)
  const long long* band;       // [L]
  const long long* mby;        // [L] band-local MB row
  const long long* mbx;        // [L] MB column
  const long long* by0;        // [L] 4x4-cell row of the MB in the band
  const long long* bx0;        // [L] 4x4-cell column
  const int* mv;               // [L, R, ns, 2] quarter-pel MVs per slot
  const int* sad;              // [L, R, ns] their SATD
  const unsigned char* ups;    // [R, 4, 4, Hf, Wp] quarter-pel planes
  const int* us;               // [R, Hcf, Wc] padded chroma
  const int* vs;
  const int* wp_c;             // [R, 4] chroma WP weights, or null
  const int* org;              // [L, 16, 16]
  const int* orgc;             // [L, 2, 8, 8]
  const int* ar_p;             // [L, 4, 4] adaptive rounding offsets (Q11)
  const int* l_nnz;            // [L, 4] counts left of the MB
  const int* t_nnz;            // [L, 4] above it
  const unsigned char* forced; // [L] forced intra
  const int* qp;               // [L]
  const int* qpc;              // [L] chroma QP
  const double* lam;           // [L]
  const double* lam_me;        // [L]
  const int* mf;               // [6, 4, 4] LevelScale (inter)
  const int* ils;              // [6, 4, 4] InvLevelScale (x16 when flat)
  const int* sub_pred;         // [L, 16, 16] the P_8x8 sub candidate, or null
  const int* sub_predc;        // [L, 2, 8, 8]
  const long long* sub_hdr;    // [L]
  const int* sub_ref;          // [L]
  int R, ns, n_valid, sh4, w4, Hf, Wp, Hcf, Wc, P, PC, band_h, M;
};

struct Out {
  int* pred16;                 // [L, M, 16, 16]
  int* predc;                  // [L, M, 2, 8, 8]
  long long* hdr;              // [L, M]
  int* ref;                    // [L, M]
  int* mvds;                   // [L, M, 4, 2]
  int* mvs;                    // [L, M, 4, 2]
  int* smv;                    // [L, 2]
  int* pred16_sk;              // [L, 16, 16]
  int* predc_sk;               // [L, 2, 8, 8]
  int* zzc;                    // [L, M, 16, 16] coding-order blocks
  int* rec;                    // [L, M, 16, 16]
  int* cbpL;                   // [L, M]
  int* fadj;                   // [L, M, 4, 4]
  int* dcl;                    // [L, M, 2, 4]
  int* acz;                    // [L, M, 2, 2, 2, 15]
  int* crecs;                  // [L, M, 2, 8, 8]
  int* cbpC;                   // [L, M]
  int* lum_bits;               // [L, M]
  float* cost;                 // [L, M]
  float* cost_sk;              // [L]
};

// One 4x4 MV cell as device_enc._cell_read gives it: unavailable cells
// read mv 0 and ref -1.
struct Cell {
  int x, y, ref;
  bool av;
};

__device__ __forceinline__ int ue_len(int v) {
  return 2 * (cavlc::bitlen(v + 1) - 1) + 1;
}

__device__ __forceinline__ int se_len(int v) {
  return ue_len(v > 0 ? 2 * v - 1 : -2 * v);
}

__device__ __forceinline__ int te_len(int v, int n_valid) {
  return n_valid <= 1 ? 0 : n_valid == 2 ? 1 : ue_len(v);
}

// The partition of mode m that holds MB-local 4x4 cell (ly, lx)
// (device_enc._PART_MAP).
__device__ __forceinline__ int part_of(int m, int ly, int lx) {
  return m == 0 ? 0 : m == 1 ? ly >> 1 : m == 2 ? lx >> 1
       : (ly >> 1) * 2 + (lx >> 1);
}

// The slot of mode m that covers the MB's 8x8 cell (cy8, cx8).
__device__ __forceinline__ int slot_of(int m, int cy8, int cx8) {
  return m == 0 ? 0 : m == 1 ? 1 + cy8 : m == 2 ? 3 + cx8
       : 5 + cy8 * 2 + cx8;
}

// The MV cells a predictor reads: outside the MB from the band state
// (nb: rows -1..3, columns -1..4 around the MB); inside it the partitions
// of mode m before partition pi, each at ref r with its MV in pmv (the
// overlay of device_enc._inter_candidates; m < 0 is the empty overlay).
struct Field {
  const Cell (*nb)[6];
  int m, pi, r;
  const int (*pmv)[2];
  __device__ __forceinline__ Cell operator()(int ly, int lx) const {
    if (ly >= 0 && ly < 4 && lx >= 0 && lx < 4) {
      if (m >= 0) {
        const int q = part_of(m, ly, lx);
        if (q < pi) return Cell{pmv[q][0], pmv[q][1], r, true};
      }
      return Cell{0, 0, -1, false};
    }
    return nb[ly + 1][lx + 1];
  }
};

__device__ __forceinline__ int median3(int a, int b, int c) {
  return a + b + c - min(min(a, b), c) - max(max(a, b), c);
}

// Spec 8.4.1.3 median predictor of the partition at MB-local cell (dy4,
// dx4), w4 cells wide, for ref r (device_enc._predict_mv).
__device__ void predict_mv(const Field& f, int dy4, int dx4, int w4, int r,
                           int dir, int* px, int* py) {
  const Cell a = f(dy4, dx4 - 1), b = f(dy4 - 1, dx4);
  const Cell d = f(dy4 - 1, dx4 - 1);
  Cell c = f(dy4 - 1, dx4 + w4);
  if (!c.av) {
    c.x = d.x;
    c.y = d.y;
    c.ref = d.ref;
  }
  c.av = c.av || d.av;
  const bool ma = a.ref == r, mb = b.ref == r, mc = c.ref == r;
  const bool one = (int)ma + (int)mb + (int)mc == 1;
  const bool only_a = a.av && !b.av && !c.av;
  int x = only_a ? a.x : one ? (ma ? a.x : mb ? b.x : c.x)
                             : median3(a.x, b.x, c.x);
  int y = only_a ? a.y : one ? (ma ? a.y : mb ? b.y : c.y)
                             : median3(a.y, b.y, c.y);
  if (dir == 2 && mb) {
    x = b.x;
    y = b.y;
  } else if (dir == 1 && ma) {
    x = a.x;
    y = a.y;
  } else if (dir == 3 && mc) {
    x = c.x;
    y = c.y;
  }
  *px = x;
  *py = y;
}

// cbp_luma of the MB from its raster blocks' TotalCoeff: bit g set when an
// 8x8 group holds a nonzero level (device_enc._cbp_bits)
__device__ __forceinline__ int cbp_luma(const int* nnz) {
  int cbp = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int b = (g >> 1) * 8 + (g & 1) * 2;
    cbp |= (nnz[b] | nnz[b + 1] | nnz[b + 4] | nnz[b + 5]) ? 1 << g : 0;
  }
  return cbp;
}

// v summed over this thread's warp into scratch[warp] (every thread of
// the warp calls it).
__device__ __forceinline__ void warp_sum_into(int v, int* scratch) {
  const int s = (int)__reduce_add_sync(0xffffffffu, (unsigned)v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
}

__global__ void __launch_bounds__(THREADS)
inter_rd_kernel(In in, Out out) {
  __shared__ Cell nb[5][6];
  __shared__ float me_cost[MAX_R];
  __shared__ int me_bits[MAX_R], me_mvd[MAX_R][4][2];
  __shared__ int pm0[2], smv[2], hdr_s;
  __shared__ int mfL[16], ilsL[16], offL[16], mfC[16], ilsC[16];
  __shared__ int tmpL[256], deqL[256], adjL[256], zzL[16][16], nnzL[16];
  __shared__ int tmpC[128], deqC[128], zzC[8][16], wdc[8], dcl_s[2][4];
  __shared__ int lbits[16], cbits[8], dbits[2], ssd_w[WARPS];

  const int l = blockIdx.x, cand = blockIdx.y, t = threadIdx.x;
  const int M = in.M;
  const bool skip = cand == M;
  const bool sub = in.sub_pred != nullptr && cand == M - 1;
  const int R = in.R, ns = in.ns;
  const int qp = in.qp[l], per = qp / 6, rem = qp % 6;
  const int qpc = in.qpc[l], perc = qpc / 6, remc = qpc % 6;
  const int off_c = OFFSET_INTER << (4 + perc);
  const long long mc = (long long)M * l + cand;   // [L, M] row of outputs

  // ---- the lane's tables and the MV cells around the MB ----
  if (t < 16) {
    mfL[t] = in.mf[rem * 16 + t];
    ilsL[t] = in.ils[rem * 16 + t];
    offL[t] = in.ar_p[l * 16 + t] << (4 + per);
  } else if (t < 32) {
    mfC[t - 16] = in.mf[remc * 16 + t - 16];
    ilsC[t - 16] = in.ils[remc * 16 + t - 16];
  } else if (t < 62) {
    const int i = t - 32, ly = i / 6 - 1, lx = i % 6 - 1;
    const long long by = in.by0[l] + ly, bx = in.bx0[l] + lx;
    Cell c{0, 0, -1, false};
    if (by >= 0 && bx >= 0 && by < in.sh4 && bx < in.w4) {
      const long long k = (in.band[l] * in.sh4 + by) * in.w4 + bx;
      const int ref = in.st_ref[k];
      if (ref > -2) c = Cell{in.st_mv[2 * k], in.st_mv[2 * k + 1], ref, true};
    }
    nb[ly + 1][lx + 1] = c;
  }
  __syncthreads();

  // ---- motion: the mode's reference choice, pm0 and P_Skip's MV ----
  if (cand < 4 && t < R) {
    const int m = cand, r = t;
    int pmv[4][2];
    int bits = HDR_BITS[m] + N_PARTS[m] * te_len(r, in.n_valid), sad = 0;
    for (int pi = 0; pi < N_PARTS[m]; ++pi) {
      const int s = FIRST_SLOT[m] + pi;
      const Field f{nb, m, pi, r, pmv};
      int px, py;
      predict_mv(f, 2 * SLOT_GEO[s][0], 2 * SLOT_GEO[s][1],
                 2 * SLOT_GEO[s][3], r, SLOT_DIR[s], &px, &py);
      const long long k = ((long long)l * R + r) * ns + s;
      const int mx = in.mv[2 * k], my = in.mv[2 * k + 1];
      bits += se_len(mx - px) + se_len(my - py);
      sad += in.sad[k];
      pmv[pi][0] = mx;
      pmv[pi][1] = my;
      me_mvd[r][pi][0] = mx - px;
      me_mvd[r][pi][1] = my - py;
    }
    me_bits[r] = bits;
    me_cost[r] = r < in.n_valid ? rd_cost(in.lam_me[l], bits, sad) : BIG;
  } else if (t == 32) {
    const Field f{nb, -1, 0, 0, nullptr};
    int px, py;
    predict_mv(f, 0, 0, 4, 0, 0, &px, &py);
    const Cell a = nb[1][0], b = nb[0][1];
    const bool zero_a = a.ref == 0 && a.x == 0 && a.y == 0;
    const bool zero_b = b.ref == 0 && b.x == 0 && b.y == 0;
    const bool use_zero = !a.av || !b.av || zero_a || zero_b;
    pm0[0] = px;
    pm0[1] = py;
    smv[0] = use_zero ? 0 : px;
    smv[1] = use_zero ? 0 : py;
  }
  __syncthreads();

  int best = 0;                       // the first least ME cost
  if (cand < 4)
    for (int i = 1; i < R; ++i)
      if (me_cost[i] < me_cost[best]) best = i;
  if (t == 0 && skip) {
    out.smv[2 * l] = smv[0];
    out.smv[2 * l + 1] = smv[1];
  } else if (t == 0) {
    int hdr, ref;
    if (cand < 4) {
      hdr = me_bits[best];
      ref = best;
    } else if (sub) {
      hdr = (int)in.sub_hdr[l];
      ref = in.sub_ref[l];
    } else {
      hdr = 3 + te_len(0, in.n_valid);
      ref = 0;
    }
    hdr_s = hdr;
    out.hdr[mc] = hdr;
    out.ref[mc] = ref;
    for (int pi = 0; pi < 4; ++pi) {
      int d[2] = {0, 0}, v[2] = {0, 0};
      if (cand < 4 && pi < N_PARTS[cand]) {
        const long long k =
            ((long long)l * R + best) * ns + FIRST_SLOT[cand] + pi;
        d[0] = me_mvd[best][pi][0];
        d[1] = me_mvd[best][pi][1];
        v[0] = in.mv[2 * k];
        v[1] = in.mv[2 * k + 1];
      } else if (cand == 4) {
        v[0] = pm0[0];
        v[1] = pm0[1];
      }
      out.mvds[(mc * 4 + pi) * 2] = d[0];
      out.mvds[(mc * 4 + pi) * 2 + 1] = d[1];
      out.mvs[(mc * 4 + pi) * 2] = v[0];
      out.mvs[(mc * 4 + pi) * 2 + 1] = v[1];
    }
  }

  // ---- motion compensation: this thread's pixel of the prediction ----
  const bool luma = t < 256;
  const int q = luma ? t : t - 256;            // pixel in its plane(s)
  const int ci = luma ? 0 : q >> 6;            // chroma component
  const int y = luma ? q >> 4 : (q >> 3) & 7, x = luma ? q & 15 : q & 7;
  const int r4 = y & 3, c4 = x & 3, p = r4 * 4 + c4;   // in its 4x4 block
  const int blk = luma ? (y >> 2) * 4 + (x >> 2)       // raster block
                       : ci * 4 + (y >> 2) * 2 + (x >> 2);
  const int org = luma ? in.org[l * 256 + q] : in.orgc[l * 128 + q];
  int pred;
  if (sub) {
    pred = luma ? in.sub_pred[l * 256 + q] : in.sub_predc[l * 128 + q];
  } else {
    int r = 0, mx, my, oy = 0, ox = 0, bh = 16, bw = 16;
    if (cand < 4) {
      const int sh = luma ? 3 : 2;
      const int s = slot_of(cand, y >> sh, x >> sh);
      const long long k = ((long long)l * R + best) * ns + s;
      r = best;
      mx = in.mv[2 * k];
      my = in.mv[2 * k + 1];
      oy = SLOT_GEO[s][0] * 8;
      ox = SLOT_GEO[s][1] * 8;
      bh = SLOT_GEO[s][2] * 8;
      bw = SLOT_GEO[s][3] * 8;
    } else {
      mx = skip ? smv[0] : pm0[0];
      my = skip ? smv[1] : pm0[1];
    }
    const long long band = in.band[l];
    if (luma) {
      const int P = in.P;
      const int iy = min(max((int)(16 * in.mby[l]) + oy + P + (my >> 2), 0),
                         in.band_h + 2 * P - bh) + (int)band * in.band_h;
      const int ix = min(max((int)(16 * in.mbx[l]) + ox + P + (mx >> 2), 0),
                         in.Wp - bw);
      const long long plane = ((long long)r * 4 + (my & 3)) * 4 + (mx & 3);
      pred = in.ups[(plane * in.Hf + iy + (y - oy)) * in.Wp + ix + (x - ox)];
    } else {
      oy >>= 1;
      ox >>= 1;
      bh >>= 1;
      bw >>= 1;
      const int PC = in.PC, hc = in.band_h / 2;
      const int fx = mx & 7, fy = my & 7;
      const int iy = min(max((int)(8 * in.mby[l]) + oy + PC + (my >> 3), 0),
                         hc + 2 * PC - (bh + 1)) + (int)band * hc;
      const int ix = min(max((int)(8 * in.mbx[l]) + ox + PC + (mx >> 3), 0),
                         in.Wc - (bw + 1));
      const int* pl = ci ? in.vs : in.us;
      const long long k =
          ((long long)r * in.Hcf + iy + (y - oy)) * in.Wc + ix + (x - ox);
      const int A = pl[k], B = pl[k + 1], C = pl[k + in.Wc];
      const int D = pl[k + in.Wc + 1];
      pred = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
              + (8 - fx) * fy * C + fx * fy * D + 32) >> 6;
      if (in.wp_c != nullptr) {
        const int w = in.wp_c[r * 4 + 2 * ci], o = in.wp_c[r * 4 + 2 * ci + 1];
        pred = min(max(((pred * w + 16) >> 5) + o, 0), 255);
      }
    }
  }
  const int diff = org - pred;

  if (skip) {                          // P_Skip: the prediction is the MB
    if (luma) out.pred16_sk[l * 256 + q] = pred;
    else out.predc_sk[l * 128 + q] = pred;
    warp_sum_into(diff * diff, ssd_w);
    __syncthreads();
    if (t == 0) {
      int ssd = 0;
      for (int i = 0; i < WARPS; ++i) ssd += ssd_w[i];
      out.cost_sk[l] = in.forced[l] ? BIG : rd_cost(in.lam[l], 1, ssd);
    }
    return;
  }
  if (luma) {
    out.pred16[mc * 256 + q] = pred;
    tmpL[blk * 16 + p] = diff;
  } else {
    out.predc[mc * 128 + q] = pred;
    tmpC[blk * 16 + p] = diff;
  }
  __syncthreads();

  // ---- transform and quantiser; luma dequantiser ----
  int lev;
  if (luma) {
    const int w = fdct_at(tmpL + blk * 16, r4, c4);
    lev = quant(w, mfL[p], offL[p], per);
    zzL[blk][ZZ_INV[p]] = lev;
    deqL[blk * 16 + p] = dequant(lev, ilsL[p], per);
    adjL[blk * 16 + p] = ar_adjust(w, lev, mfL[p], per);
    out.zzc[(mc * 16 + SCAN_INV[blk]) * 16 + ZZ_INV[p]] = lev;
  } else {
    const int w = fdct_at(tmpC + blk * 16, r4, c4);
    lev = p == 0 ? 0 : quant(w, mfC[p], off_c, perc);
    if (p == 0) wdc[blk] = w;
    zzC[blk][ZZ_INV[p]] = lev;
  }
  const bool any_ac = __syncthreads_or(!luma && lev != 0);

  // ---- luma inverse rows, counts and rounding sums; chroma DC ----
  int dc = 0;
  if (luma) {
    tmpL[blk * 16 + p] = idct_row(deqL + blk * 16, r4, c4);
    if (t < 16) {
      int n = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) n += zzL[t][i] != 0;
      nnzL[t] = n;
    } else if (t < 32) {
      unsigned s = 0;                  // int32 wrap-around, as the tensors
      for (int b = 0; b < 16; ++b) s += (unsigned)adjL[b * 16 + t - 16];
      out.fadj[mc * 16 + t - 16] = (int)s;
    }
  } else if ((q & 63) < 4) {           // DC level k of component ci
    const int k = q & 63, b0 = ci * 4;
    const int a = wdc[b0], b = wdc[b0 + 1], c = wdc[b0 + 2], e = wdc[b0 + 3];
    const int h = k == 0 ? a + b + c + e : k == 1 ? a - b + c - e
                : k == 2 ? a + b - c - e : a - b - c + e;
    const int lv = min((abs(h) * mfC[0] + (off_c << 1)) >> (16 + perc),
                       LEVEL_LIMIT);
    dc = h < 0 ? -lv : h > 0 ? lv : 0;
    dcl_s[ci][k] = dc;
  }
  const bool any_dc = __syncthreads_or(dc != 0);
  const int cbp_c = any_ac ? 2 : any_dc ? 1 : 0;

  // ---- luma reconstruction; chroma dequantiser ----
  int sq = 0;
  if (luma) {
    const int v = recon(pred, idct_col(tmpL + blk * 16, r4, c4));
    out.rec[mc * 256 + q] = v;
    sq = (org - v) * (org - v);
  } else {
    int d;
    if (p == 0) {
      const int k = blk & 3;
      const int* L4 = dcl_s[ci];
      const int s = k == 0 ? L4[0] + L4[1] + L4[2] + L4[3]
                  : k == 1 ? L4[0] - L4[1] + L4[2] - L4[3]
                  : k == 2 ? L4[0] + L4[1] - L4[2] - L4[3]
                           : L4[0] - L4[1] - L4[2] + L4[3];
      d = cbp_c >= 1 ? ((s * ilsC[0]) << perc) >> 5 : 0;
      out.dcl[(mc * 2 + ci) * 4 + k] = cbp_c >= 1 ? L4[k] : 0;
    } else {
      d = cbp_c == 2 ? dequant(lev, ilsC[p], perc) : 0;
      out.acz[(mc * 8 + blk) * 15 + ZZ_INV[p] - 1] = cbp_c == 2 ? lev : 0;
    }
    deqC[blk * 16 + p] = d;
  }
  if (luma) warp_sum_into(sq, ssd_w);
  __syncthreads();

  // ---- chroma inverse rows; the bit estimates ----
  if (!luma) {
    tmpC[blk * 16 + p] = idct_row(deqC + blk * 16, r4, c4);
  } else if (t < 16) {                 // luma block k in coding order
    const int y4 = SCAN_Y[t], x4 = SCAN_X[t];
    const long long mbx = in.mbx[l], mby = in.mby[l];
    const bool av_a = x4 > 0 || mbx > 0, av_b = y4 > 0 || mby > 0;
    const int na = x4 > 0 ? nnzL[y4 * 4 + x4 - 1] : in.l_nnz[l * 4 + y4];
    const int nbv = y4 > 0 ? nnzL[(y4 - 1) * 4 + x4] : in.t_nnz[l * 4 + x4];
    const int nc = av_a && av_b ? (na + nbv + 1) >> 1
                 : av_a ? na : av_b ? nbv : 0;
    lbits[t] = (cbp_luma(nnzL) >> (t >> 2)) & 1
                   ? cavlc::block_bits_est<16>(zzL[y4 * 4 + x4], nc) : 0;
  } else if (t >= 32 && t < 40) {      // chroma AC block (ci, by, bx)
    cbits[t - 32] = cavlc::block_bits_est<15>(zzC[t - 32] + 1, 0);
  } else if (t >= 64 && t < 66) {      // chroma DC block of component ci
    dbits[t - 64] = cavlc::block_bits_est<4, true>(dcl_s[t - 64], 0);
  }
  __syncthreads();

  // ---- chroma reconstruction ----
  if (!luma) {
    const int v = recon(pred, idct_col(tmpC + blk * 16, r4, c4));
    out.crecs[mc * 128 + q] = v;
    sq = (org - v) * (org - v);
    warp_sum_into(sq, ssd_w);
  }
  __syncthreads();

  // ---- the candidate's bits and RD cost ----
  if (t == 0) {
    int ssd = 0, lum = 0, cac = 0;
    for (int i = 0; i < WARPS; ++i) ssd += ssd_w[i];
    for (int i = 0; i < 16; ++i) lum += lbits[i];
    for (int i = 0; i < 8; ++i) cac += cbits[i];
    const int cbp_l = cbp_luma(nnzL);
    const int res = lum + (cbp_c >= 1 ? dbits[0] + dbits[1] : 0)
                  + (cbp_c == 2 ? cac : 0);
    const int cbp = cbp_l | (cbp_c << 4);
    const int bits = hdr_s + 1 + ue_len(CBP_INTER[cbp]) + (cbp > 0) + res;
    out.cbpL[mc] = cbp_l;
    out.cbpC[mc] = cbp_c;
    out.lum_bits[mc] = lum;
    out.cost[mc] = in.forced[l] ? BIG : rd_cost(in.lam[l], bits, ssd);
  }
}

}  // namespace

extern "C" int inter_rd_launch(
    const void* st_mv, const void* st_ref, const void* band, const void* mby,
    const void* mbx, const void* by0, const void* bx0, const void* mv,
    const void* sad, const void* ups, const void* us, const void* vs,
    const void* wp_c, const void* org, const void* orgc, const void* ar_p,
    const void* l_nnz, const void* t_nnz, const void* forced, const void* qp,
    const void* qpc, const void* lam, const void* lam_me, const void* mf,
    const void* ils, const void* sub_pred, const void* sub_predc,
    const void* sub_hdr, const void* sub_ref, void* pred16, void* predc,
    void* hdr, void* ref, void* mvds, void* mvs, void* smv, void* pred16_sk,
    void* predc_sk, void* zzc, void* rec, void* cbpL, void* fadj, void* dcl,
    void* acz, void* crecs, void* cbpC, void* lum_bits, void* cost,
    void* cost_sk, int L, int M, int R, int ns, int n_valid, int sh4, int w4,
    int Hf, int Wp, int Hcf, int Wc, int P, int PC, int band_h, int device,
    void* stream) {
  if (L < 1 || R < 1 || R > MAX_R || ns < 9 || (M != 5 && M != 6)
      || (M == 6) != (sub_pred != nullptr))
    return (int)cudaErrorInvalidValue;
  int prev = -1;                      // the caller's device, put back after
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const In in{static_cast<const int*>(st_mv), static_cast<const int*>(st_ref),
              static_cast<const long long*>(band),
              static_cast<const long long*>(mby),
              static_cast<const long long*>(mbx),
              static_cast<const long long*>(by0),
              static_cast<const long long*>(bx0),
              static_cast<const int*>(mv), static_cast<const int*>(sad),
              static_cast<const unsigned char*>(ups),
              static_cast<const int*>(us), static_cast<const int*>(vs),
              static_cast<const int*>(wp_c), static_cast<const int*>(org),
              static_cast<const int*>(orgc), static_cast<const int*>(ar_p),
              static_cast<const int*>(l_nnz), static_cast<const int*>(t_nnz),
              static_cast<const unsigned char*>(forced),
              static_cast<const int*>(qp), static_cast<const int*>(qpc),
              static_cast<const double*>(lam),
              static_cast<const double*>(lam_me),
              static_cast<const int*>(mf), static_cast<const int*>(ils),
              static_cast<const int*>(sub_pred),
              static_cast<const int*>(sub_predc),
              static_cast<const long long*>(sub_hdr),
              static_cast<const int*>(sub_ref),
              R, ns, n_valid, sh4, w4, Hf, Wp, Hcf, Wc, P, PC, band_h, M};
  const Out out{static_cast<int*>(pred16), static_cast<int*>(predc),
                static_cast<long long*>(hdr), static_cast<int*>(ref),
                static_cast<int*>(mvds), static_cast<int*>(mvs),
                static_cast<int*>(smv), static_cast<int*>(pred16_sk),
                static_cast<int*>(predc_sk), static_cast<int*>(zzc),
                static_cast<int*>(rec), static_cast<int*>(cbpL),
                static_cast<int*>(fadj), static_cast<int*>(dcl),
                static_cast<int*>(acz), static_cast<int*>(crecs),
                static_cast<int*>(cbpC), static_cast<int*>(lum_bits),
                static_cast<float*>(cost), static_cast<float*>(cost_sk)};
  inter_rd_kernel<<<dim3(L, M + 1), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(in, out);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
