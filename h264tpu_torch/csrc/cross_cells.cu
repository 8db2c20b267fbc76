// cross_cells.cu — the Σr·d cross-correlation core of the fractal search.
//
// Replaces the TPU kernel h264tpu/ops/fractal.py:338 pallas_cross_rows
// (together with the 4-column pool its caller runs in XLA, fractal.py:486).
// For every reference plane r, every candidate offset k = (dx, dy) and every
// aligned 4x4 cell (cy, cx):
//
//   cross4[r, k, cy, cx] = sum_{i,j<4} org[4cy+i, 4cx+j]
//                          * refs_pad[r, sr+4cy+i+dy, sr+4cx+j+dx]
//
// Inputs are pixels, 0..255, as the main path passes them (uint8 planes,
// truncating half-pel averages, zero padding): the kernel packs them to bytes.
//
// What bounds it: the bytes it stores.  At CIF luma with SR 7 (R = 4 planes
// C/H/M/N, 225 offsets) it writes 22.8 MB of cross4 and reads 1.7 MB, and
// does 91 M multiply-adds.  On an H100 the store takes ~7 us at 3.35 TB/s;
// the multiply-adds as int32 IMADs ~6 us, as 4-way byte dot products ~3 us.
// Everything else has to stay out of their way.
//
// What the design does about each cost.
// - Shared-memory traffic.  A thread owns one cell; its 4 org rows sit in 4
//   registers, one byte per pixel.  It slides down its column of the staged
//   window: each ref row segment (the 4+2sr pixels every dx of a cell row
//   needs) is loaded once and serves the 4 dy rows that use it, into 4 sets
//   of 2sr+1 accumulators.  That is ~(4+2sr)/4 words per (cell, ref, dy),
//   5 at SR 7, where one scalar load per tap took 240.  Above SR 7 dx runs
//   in groups of G = 12 (the template argument), so at most 4 x 15
//   accumulators are live.
// - Bank conflicts.  A warp covers 32 consecutive cells of one row, so its
//   segment loads read consecutive words, and each store of a warp writes
//   one whole 128-byte line of cross4.
// - Arithmetic.  The window is packed to bytes once per block; the 4 shifted
//   byte words of a segment come from funnel shifts, and each (cell row, dx)
//   is one __dp4a: a quarter of the multiply-add instructions, exact in
//   int32.  Each store is one wide multiply-add of its slot offset.
// - Offsets by position, not by chunk.  The block walks the (2sr+1)^2 box in
//   raster order and writes each sum to its spiral slot through the table
//   slots[(dy+sr)*(2sr+1) + dx+sr] (the index into the caller's offsets, or
//   -1), built once on the host (ops/fractal.py offset_slots).  A dy row or
//   dx group that holds no slot is skipped.  One build serves every search
//   range and search mode, and no block stages a window for one offset.
// - Staging.  The grid splits over (32x4-cell tile, ref, dy group).  Each
//   block stages its int32 window with asynchronous copies, all in flight
//   at once (16 bytes where the row is aligned), so a block waits for one
//   round trip to memory, not one per word.  The dy group is sized on the
//   host from the kernel's occupancy: as tall as keeps the waves of blocks
//   even, since every block stages its own window.
// - Tensor cores: not used.  Each cell's dot product has its own 16 taps
//   and its own shifted operands; no operand is shared across cells, so an
//   mma/wgmma form is a batch of M = 1 products.  The multiply-adds sit
//   under the store bound on the CUDA cores.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int TCX = 32;            // cells per block along x
constexpr int TCY = 4;             // cells per block along y
constexpr int NT = TCX * TCY;      // one thread per cell
constexpr int MAX_DYG = 64;        // dy rows per block: one bit each in a mask
constexpr size_t MAX_SMEM = 100 * 1024;
// Packed words per row segment of a G-wide dx group: bytes 0..G+2.
__host__ __device__ constexpr int seg_words(int G) { return (G + 6) / 4; }

// Window row stride in pixels: covers every segment read, a multiple of 4.
inline int win_stride(int G, int n_groups) {
  return 4 * (TCX - 1) + (n_groups - 1) * G + 4 * seg_words(G);
}

// Slot row length in words: the box's dx range, padded to a multiple of 4.
inline int slot_stride(int G, int n_groups) {
  return (n_groups * G + 3) / 4 * 4;
}

// Words of the int32 window as staged, of the same window packed to bytes
// (padded to 16 bytes), then the slot rows and one live mask per dx group.
inline size_t smem_bytes(int G, int n_groups, int dyg) {
  const size_t win = (size_t)(4 * TCY + dyg - 1) * win_stride(G, n_groups);
  return sizeof(int) * (win + (win / 4 + 3) / 4 * 4 +
                        (size_t)dyg * slot_stride(G, n_groups)) +
         sizeof(unsigned long long) * n_groups;
}

// Asynchronous copy of BYTES (4, 8 or 16) global -> shared that reads the
// first src_bytes of them and zero-fills the rest.
template <int BYTES>
__device__ __forceinline__ void cp_async(int* dst, const int* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

// Stage words [0, stride) of one window row from src, of which the first
// `left` lie in the plane; chunks of BYTES per lane, zeros past the plane.
template <int BYTES>
__device__ __forceinline__ void stage_row(int* dst, const int* src, int left,
                                          int stride, int lane) {
  constexpr int V = BYTES / 4;
  for (int c = V * lane; c < stride; c += 32 * V) {
    const int n = min(max(left - c, 0), V);
    if (n) {
      cp_async<BYTES>(dst + c, src + c, 4 * n);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) dst[c + v] = 0;
    }
  }
}

// The low bytes of a, b, c, d as one word, a in the lowest byte.
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <int G>
__global__ void __launch_bounds__(NT, 4)
cross_cells_kernel(const int* __restrict__ org,
                   const int* __restrict__ refs_pad,
                   const int* __restrict__ slots,
                   int* __restrict__ out,
                   int H, int W, int n_off, int sr, int n_groups, int dyg,
                   int n_dyg, int stride, int sstride) {
  constexpr int NW = seg_words(G);
  constexpr int NS = (G + 3) / 4;
  extern __shared__ int4 smem4[];
  const int PH = H + 2 * sr;
  const int PW = W + 2 * sr;
  const int CY = H / 4;
  const int CX = W / 4;
  const int nd = 2 * sr + 1;
  const int cx0 = blockIdx.x * TCX;
  const int cy0 = blockIdx.y * TCY;
  const int r = blockIdx.z / n_dyg;
  const int dy0 = -sr + (blockIdx.z % n_dyg) * dyg;
  const int ndy = min(dyg, sr - dy0 + 1);
  const int rows = 4 * TCY + dyg - 1;
  int* s_win = reinterpret_cast<int*>(smem4);                // [rows][stride]
  unsigned* s_pk =
      reinterpret_cast<unsigned*>(s_win + rows * stride);    // [rows][stride/4]
  int* s_slot = s_win + rows * stride + (rows * stride / 4 + 3) / 4 * 4;
  unsigned long long* s_live = reinterpret_cast<unsigned long long*>(
      s_slot + dyg * sstride);                               // [n_groups]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int g = threadIdx.x; g < n_groups; g += NT) s_live[g] = 0;
  __syncthreads();

  // stage the window with asynchronous copies, all in flight at once:
  // padded rows 4cy0+sr+dy0+rho, cols 4cx0+c; past the padded plane's edge
  // reads zero.  16-byte copies where the row is aligned, else 8 or 4.
  const int* ref_r = refs_pad + (size_t)r * PH * PW;
  const int gy0 = 4 * cy0 + sr + dy0;
  for (int rho = warp; rho < rows; rho += NT / 32) {
    const int gy = gy0 + rho;
    const int* src = ref_r + (size_t)gy * PW + 4 * cx0;
    int* dst = s_win + rho * stride;
    const int left = gy < PH ? PW - 4 * cx0 : 0;
    const unsigned a = static_cast<unsigned>(reinterpret_cast<size_t>(src));
    if ((a & 15) == 0)
      stage_row<16>(dst, src, left, stride, lane);
    else if ((a & 7) == 0)
      stage_row<8>(dst, src, left, stride, lane);
    else
      stage_row<4>(dst, src, left, stride, lane);
  }
  // this dy group's slots as offsets of their cross4 planes (k * CY*CX, which
  // the host keeps below 2^31), -1 past the box and where no offset is; bit
  // dyl of s_live[g] says that row dyl of dx group g holds a slot
  for (int dyl = warp; dyl < ndy; dyl += NT / 32) {
    const int* row = slots + (dy0 + dyl + sr) * nd;
    for (int t0 = 0; t0 < sstride; t0 += 32) {
      const int t = t0 + lane;
      const int k = t < nd ? __ldg(row + t) : -1;
      if (t < sstride) s_slot[dyl * sstride + t] = k >= 0 ? k * CY * CX : -1;
      for (int g = t0 / G; g <= min((t0 + 31) / G, n_groups - 1); ++g) {
        if (__any_sync(0xffffffffu, k >= 0 && t / G == g) && lane == 0)
          atomicOr(s_live + g, 1ull << dyl);
      }
    }
  }

  // thread -> cell: each warp covers 32 consecutive cells of one row
  const int tx = lane;
  const int ty = warp;
  const int cx = cx0 + tx;
  const int cy = cy0 + ty;
  const bool live = cx < CX && cy < CY;
  // the cell's org rows packed to bytes (pixels: 0..255)
  unsigned orow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int* q = org + (size_t)(4 * cy + i) * W + 4 * cx;
    orow[i] = live ? pack4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3)) : 0u;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // pack the window to bytes: word m of a row holds columns 4m..4m+3
  for (int m = threadIdx.x; m < rows * stride / 4; m += NT) {
    const int4 q = reinterpret_cast<const int4*>(s_win)[m];
    s_pk[m] = pack4(q.x, q.y, q.z, q.w);
  }
  __syncthreads();
  if (!live) return;

  const int pstride = stride / 4;
  int* out_c = out + ((size_t)r * n_off * CY + cy) * CX + cx;
  // keep the cell's pointer in registers: each store is then one wide
  // multiply-add of its slot offset
  {
    size_t a = reinterpret_cast<size_t>(out_c);
    asm("" : "+l"(a));
    out_c = reinterpret_cast<int*>(a);
  }
  for (int g = 0; g < n_groups; ++g) {
    const unsigned long long rows_live = s_live[g];
    if (!rows_live) continue;
    // word-aligned: g*G is a multiple of 4 (G = 12 when n_groups > 1)
    const unsigned* col = s_pk + 4 * ty * pstride + tx + g * G / 4;
    unsigned acc[4][G];
    // slide down the window: row t of the cell's column serves cell row i
    // of dy row dyl = t - i; dy row dyl is complete after row t = dyl + 3
    for (int t0 = 0; t0 < ndy + 3; t0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u;
        if (t < ndy + 3) {
          unsigned w[NW + 1];
#pragma unroll
          for (int v = 0; v < NW; ++v) w[v] = col[t * pstride + v];
          w[NW] = 0;
          unsigned sh[G];   // bytes d..d+3 of the row segment
#pragma unroll
          for (int d = 0; d < G; ++d)
            sh[d] = d % 4 ? __funnelshift_r(w[d / 4], w[d / 4 + 1], 8 * (d % 4))
                          : w[d / 4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int dyl = t - i;
            if (dyl >= 0 && dyl < ndy && ((rows_live >> dyl) & 1)) {
#pragma unroll
              for (int d = 0; d < G; ++d)
                acc[(u - i) & 3][d] =
                    __dp4a(orow[i], sh[d], i == 0 ? 0u : acc[(u - i) & 3][d]);
            }
          }
          const int dyl = t - 3;
          if (dyl >= 0 && ((rows_live >> dyl) & 1)) {
            const int4* sp =
                reinterpret_cast<const int4*>(s_slot + dyl * sstride + g * G);
            int sv[4 * NS];
#pragma unroll
            for (int v = 0; v < NS; ++v) {
              const int4 q = sp[v];
              sv[4 * v] = q.x;
              sv[4 * v + 1] = q.y;
              sv[4 * v + 2] = q.z;
              sv[4 * v + 3] = q.w;
            }
#pragma unroll
            for (int d = 0; d < G; ++d)
              if (sv[d] >= 0) out_c[sv[d]] = (int)acc[(u + 1) & 3][d];
          }
        }
      }
    }
  }
}

template <int G>
cudaError_t launch(const int* org, const int* refs_pad, const int* slots,
                   int* out, int H, int W, int R, int n_off, int sr,
                   int n_groups, int sms, cudaStream_t stream) {
  const int nd = 2 * sr + 1;
  const int CY = H / 4;
  const int CX = W / 4;
  const int pairs = ((CX + TCX - 1) / TCX) * ((CY + TCY - 1) / TCY) * R;
  int resident = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, cross_cells_kernel<G>, NT,
      smem_bytes(G, n_groups, std::min(nd, MAX_DYG)));
  if (err != cudaSuccess) return err;
  const long slots_on_card = (long)sms * std::max(resident, 1);
  // dy rows per block: each block reads dyg + 3 window rows per cell and
  // stages its own window, so fewer, taller blocks cost less, as long as the
  // waves of blocks come out even.  Cost ~ waves * (dyg + 4).
  int dyg = 0;
  long best = 0;
  for (int n = 1; n <= nd; ++n) {
    const int g = (nd + n - 1) / n;
    if (g > MAX_DYG || smem_bytes(G, n_groups, g) > MAX_SMEM) continue;
    const long blocks = (long)pairs * ((nd + g - 1) / g);
    const long cost = (blocks + slots_on_card - 1) / slots_on_card * (g + 4);
    if (!dyg || cost < best) {
      dyg = g;
      best = cost;
    }
  }
  if (!dyg) return cudaErrorInvalidValue;
  const int n_dyg = (nd + dyg - 1) / dyg;
  const size_t smem = smem_bytes(G, n_groups, dyg);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cross_cells_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((CX + TCX - 1) / TCX, (CY + TCY - 1) / TCY, R * n_dyg);
  cross_cells_kernel<G><<<grid, NT, smem, stream>>>(
      org, refs_pad, slots, out, H, W, n_off, sr, n_groups, dyg, n_dyg,
      win_stride(G, n_groups), slot_stride(G, n_groups));
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `slots` is the
// [(2sr+1)^2] int32 table from box position to offset index (or -1).
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int cross_cells_launch(const void* org, const void* refs_pad,
                                  const void* slots, void* out, int H, int W,
                                  int R, int n_off, int sr, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 4 || W < 4 || R < 1 || n_off < 1 || sr < 0) return 0;
  if ((long long)n_off * (H / 4) * (W / 4) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int* o = static_cast<const int*>(org);
  const int* rp = static_cast<const int*>(refs_pad);
  const int* sl = static_cast<const int*>(slots);
  int* y = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nd = 2 * sr + 1;
  // up to 15 dx in one group (SR <= 7); beyond that groups of 12
  switch (nd) {
    case 1: err = launch<1>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 3: err = launch<3>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 5: err = launch<5>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 7: err = launch<7>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 9: err = launch<9>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 11: err = launch<11>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 13: err = launch<13>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    case 15: err = launch<15>(o, rp, sl, y, H, W, R, n_off, sr, 1, sms, s); break;
    default:
      err = launch<12>(o, rp, sl, y, H, W, R, n_off, sr, (nd + 11) / 12, sms,
                       s);
  }
  return (int)err;
}
