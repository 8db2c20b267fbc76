// deblock.cu — the fractal codec's in-loop filter (ops/deblock.py
// deblock_plane) on a batch of planes.
//
// Replaces no TPU kernel: the reference filters with a lax.scan over edges
// (h264tpu/ops/deblock.py _vertical_pass), which XLA runs on the TPU as a
// loop of whole-column vector steps.  The port's plain version is the same
// loop in Python, and each of its steps is ~60-100 small PyTorch ops: about
// 25 000 launches a CIF 4:2:0 frame, with the card idle between them.  This
// kernel pair does the same filter in two launches per call.
//
// The filter.  For every vertical 4-px edge x = 4, 8, .., W-4 from left to
// right, then every horizontal edge y = 4, .., H-4 from top to bottom, each
// pixel line across the edge (p3 p2 p1 p0 | q0 q1 q2 q3) is filtered as
// H.264's EdgeLoop does (normal filter for bS 1-3, strong for bS 4), with
// the same int32 arithmetic as the plain version (_filter_edge_lines).  An
// edge reads pixels that the edge before it wrote, so along a line the work
// is sequential; lines are independent: the rows in the vertical pass, the
// columns in the horizontal pass.
//
// What bounds it: latency, not bytes.  A CIF luma plane is 0.4 MB of int32,
// read and written once in well under a microsecond at 3.35 TB/s, but a
// thread walks its line's 71-87 edges one after another, each a dependent
// chain of ~50 integer operations; and a plane has only a few hundred lines,
// so a few warps hold the whole card.
//
// What the design does about it.
// - One thread per line, the line's 8-pixel window p3..q3 in registers.  It
//   slides by 4 pixels per edge: the edge's outputs p2..q2 are the next
//   edge's p3..p1 without a round trip through memory, and the 4 pixels
//   behind the window are final and are stored.
// - Loads run ahead of the arithmetic: a thread fetches its next SEG chunks
//   of 4 pixels (and their edges' strengths) while it filters the current
//   SEG, so it waits for memory once per SEG edges, not once per edge.
// - Vertical pass: a row's chunk is one 16-byte load.  Horizontal pass:
//   neighbouring threads own neighbouring columns, so each load and store of
//   a warp covers 128 contiguous bytes, and bs_h is read in its natural
//   layout: no transposed copy of the plane or of the strengths.
// - Two launches per call: rows from the input into the output, then
//   columns in place in the output.  One block per plane holding the plane in
//   shared memory (one launch) was not built: a 1080p plane does not fit in
//   a block's shared memory, and a launch costs less than the one host call
//   around it.  A batch of B planes (row bands of deblock_plane_grouped, or
//   stacked planes) is B x H rows and B x W columns of one launch each.
// - Strengths at cell granularity [B, H/4, W/4], α, β and the CLIP_TAB row
//   of the call's qp as kernel arguments.

#include <cuda_runtime.h>

namespace {

constexpr int SEG = 8;        // chunks of 4 pixels fetched ahead per line
constexpr int THREADS = 64;   // lines per block: few lines, so many blocks

struct Filter {
  int alpha, beta;
  int tc0[5];   // CLIP_TAB[qp], indexed by bS clamped to 0..4
  int luma;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Filter one line across one edge in place: w = p3 p2 p1 p0 q0 q1 q2 q3.
__device__ __forceinline__ void filter_line(int (&w)[8], int bs,
                                            const Filter& f) {
  const int p3 = w[0], p2 = w[1], p1 = w[2], p0 = w[3];
  const int q0 = w[4], q1 = w[5], q2 = w[6], q3 = w[7];
  const int d0 = abs(p0 - q0);
  if (!(bs > 0 && d0 < f.alpha && abs(p1 - p0) < f.beta &&
        abs(q1 - q0) < f.beta))
    return;
  const bool ap = abs(p2 - p0) < f.beta;
  const bool aq = abs(q2 - q0) < f.beta;
  if (bs == 4) {                              // strong filter
    if (f.luma) {
      const bool small = d0 < ((f.alpha >> 2) + 2);
      const bool sp = small && ap, sq = small && aq;
      if (sp) {
        w[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
        w[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
        w[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
      } else {
        w[3] = (2 * p1 + p0 + q1 + 2) >> 2;
      }
      if (sq) {
        w[4] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
        w[5] = (q2 + q1 + q0 + p0 + 2) >> 2;
        w[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
      } else {
        w[4] = (2 * q1 + q0 + p1 + 2) >> 2;
      }
    } else {
      w[3] = (2 * p1 + p0 + q1 + 2) >> 2;
      w[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int b = min(bs, 4);                   // normal filter (bS 1-3, >4)
  const int tc0 = b == 1 ? f.tc0[1] : b == 2 ? f.tc0[2]
                : b == 3 ? f.tc0[3] : f.tc0[4];
  const int tc = f.luma ? tc0 + ap + aq : tc0 + 1;
  const int delta = clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
  w[3] = clampi(p0 + delta, 0, 255);
  w[4] = clampi(q0 - delta, 0, 255);
  if (f.luma) {
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap) w[2] = p1 + clampi((p2 + avg - 2 * p1) >> 1, -tc0, tc0);
    if (aq) w[5] = q1 + clampi((q2 + avg - 2 * q1) >> 1, -tc0, tc0);
  }
}

// The walk along one line of n chunks (4 pixels each).  Line is the memory
// access of the pass: load(c, px) fills chunk c, store(c, px) writes it,
// strength(c) is the bS of the edge left of (above) chunk c.
template <class Line>
__device__ __forceinline__ void walk(Line& line, int n, const Filter& f) {
  int cur[SEG][4], nxt[SEG][4];
  int bcur[SEG], bnxt[SEG];
#pragma unroll
  for (int k = 0; k < SEG; ++k)
    if (k < n) {
      line.load(k, cur[k]);
      bcur[k] = line.strength(k);
    }
  int w[8] = {};
  for (int base = 0; base < n; base += SEG) {
#pragma unroll
    for (int k = 0; k < SEG; ++k)             // fetch the next segment
      if (base + SEG + k < n) {
        line.load(base + SEG + k, nxt[k]);
        bnxt[k] = line.strength(base + SEG + k);
      }
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      const int c = base + k;
      if (c < n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = w[i + 4];
          w[i + 4] = cur[k][i];
        }
        if (c > 0) {
          filter_line(w, bcur[k], f);
          line.store(c - 1, w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SEG; ++k) {
      bcur[k] = bnxt[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[k][i] = nxt[k][i];
    }
  }
  line.store(n - 1, w + 4);
}

// A row of the vertical pass: chunk c is pixels 4c..4c+3 of the row.
struct Row {
  const int* __restrict__ src;
  int* __restrict__ dst;
  const int* __restrict__ bs;   // the row's cell row of bs_v
  __device__ void load(int c, int (&px)[4]) const {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + c);
    px[0] = v.x; px[1] = v.y; px[2] = v.z; px[3] = v.w;
  }
  __device__ int strength(int c) const { return __ldg(bs + c); }
  __device__ void store(int c, const int* px) const {
    reinterpret_cast<int4*>(dst)[c] = make_int4(px[0], px[1], px[2], px[3]);
  }
};

// A column of the horizontal pass, in place: chunk c is rows 4c..4c+3.
struct Col {
  int* p;                       // the column's first pixel
  const int* __restrict__ bs;   // bs_h[b, 0, x/4]
  int W, cells_x;
  __device__ void load(int c, int (&px)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) px[i] = p[(size_t)(4 * c + i) * W];
  }
  __device__ int strength(int c) const {
    return __ldg(bs + (size_t)c * cells_x);
  }
  __device__ void store(int c, const int* px) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[(size_t)(4 * c + i) * W] = px[i];
  }
};

__global__ void __launch_bounds__(THREADS)
deblock_rows_kernel(const int* __restrict__ in, const int* __restrict__ bs_v,
                    int* __restrict__ out, int B, int H, int W, Filter f) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= (long long)B * H) return;
  const long long b = r / H, y = r % H;
  Row row{in + r * W, out + r * W, bs_v + (b * (H / 4) + y / 4) * (W / 4)};
  walk(row, W / 4, f);
}

__global__ void __launch_bounds__(THREADS)
deblock_cols_kernel(int* plane, const int* __restrict__ bs_h, int B, int H,
                    int W, Filter f) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * W) return;
  const long long b = t / W, x = t % W;
  Col col{plane + b * H * W + x, bs_h + b * (H / 4) * (W / 4) + x / 4, W,
          W / 4};
  walk(col, H / 4, f);
}

}  // namespace

// out[B, H, W] = the deblocked in[B, H, W] (int32, contiguous, 16-byte
// aligned, H and W multiples of 4); bs_v, bs_h int32 [B, H/4, W/4]; tc0 the
// five entries of CLIP_TAB[qp].  Two launches on ``stream``; returns the
// first cudaError (0 on success).
extern "C" int deblock_launch(const void* in, const void* bs_v,
                              const void* bs_h, void* out, int B, int H,
                              int W, int alpha, int beta, int tc0_0,
                              int tc0_1, int tc0_2, int tc0_3, int tc0_4,
                              int luma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4)
    return (int)cudaErrorInvalidValue;
  const Filter f{alpha, beta, {tc0_0, tc0_1, tc0_2, tc0_3, tc0_4}, luma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const long long rows = (long long)B * H, cols = (long long)B * W;
  deblock_rows_kernel<<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS,
                        0, s>>>(static_cast<const int*>(in),
                                static_cast<const int*>(bs_v), o, B, H, W, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deblock_cols_kernel<<<(unsigned)((cols + THREADS - 1) / THREADS), THREADS,
                        0, s>>>(o, static_cast<const int*>(bs_h), B, H, W, f);
  return (int)cudaGetLastError();
}
