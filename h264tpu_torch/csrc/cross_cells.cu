// cross_cells.cu — the Σr·d cross-correlation core of the fractal search.
//
// Replaces the TPU kernel h264tpu/ops/fractal.py:338 pallas_cross_rows
// (together with the 4-column pool its caller runs in XLA, fractal.py:486).
// For every reference plane r, every candidate offset (dx, dy) and every
// aligned 4x4 cell (cy, cx):
//
//   cross4[r, k, cy, cx] = sum_{i,j<4} org[4cy+i, 4cx+j]
//                          * refs_pad[r, sr+4cy+i+dy, sr+4cx+j+dx]
//
// int32 throughout: the largest sum is 16 * 255^2 ~ 1.04e6.
//
// What bounds it.  Per P frame at CIF with SR 7 (R = 4 planes C/H/M/N,
// 225 offsets) the work is R*n_off*H*W = 136.9 M int32 multiply-adds over
// Y, U and V, and the cross4 maps written are 34.2 MB (Y 22.8 MB, U and V
// 5.7 MB each); the inputs are only ~2.7 MB.  On an H100 the 34.2 MB of
// output take ~10 us at 3.35 TB/s and the multiply-adds ~8 us at the int32
// rate of the CUDA cores, so the kernel is bound by the bytes it writes.
//
// What the design does about it.  Each input byte comes from device memory
// about once per block: a block owns a tile of 8 x 32 cells (32 x 128
// pixels) of one reference plane and a chunk of 32 offsets, stages that
// plane's (32+2sr) x (128+2sr) window in shared memory once, and every
// thread keeps its cell's 16 org pixels in registers for the whole chunk.
// The 4x4 pool is fused, so only cross4 itself is written (once, coalesced
// along cx); the row-pooled [R, n_off, H/4, W] intermediate of the TPU
// kernel never exists.  Offsets are read from device memory rather than
// being compile-time constants, so one build serves every search range and
// search mode.  Shared-memory reads have 4-way bank conflicts (neighbouring
// threads read 4 words apart); removing them is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int TCX = 32;            // cells per block along x
constexpr int TCY = 8;             // cells per block along y
constexpr int OFF_PER_BLOCK = 32;  // offsets per block

__global__ void __launch_bounds__(TCX * TCY)
cross_cells_kernel(const int* __restrict__ org,
                   const int* __restrict__ refs_pad,
                   const int* __restrict__ offsets,
                   int* __restrict__ out,
                   int H, int W, int n_off, int sr, int n_chunks) {
  extern __shared__ int s_win[];
  const int PH = H + 2 * sr;
  const int PW = W + 2 * sr;
  const int CY = H / 4;
  const int CX = W / 4;
  const int cx0 = blockIdx.x * TCX;
  const int cy0 = blockIdx.y * TCY;
  const int r = blockIdx.z / n_chunks;
  const int chunk = blockIdx.z % n_chunks;
  const int win_h = 4 * TCY + 2 * sr;
  const int win_w = 4 * TCX + 2 * sr;

  // stage the reference window: padded rows [4cy0, 4cy0+win_h), cols
  // [4cx0, 4cx0+win_w); past the padded plane's edge reads zero
  const int* ref_r = refs_pad + (size_t)r * PH * PW;
  for (int i = threadIdx.x; i < win_h * win_w; i += blockDim.x) {
    const int gy = 4 * cy0 + i / win_w;
    const int gx = 4 * cx0 + i % win_w;
    s_win[i] = (gy < PH && gx < PW) ? ref_r[(size_t)gy * PW + gx] : 0;
  }

  const int tx = threadIdx.x % TCX;
  const int ty = threadIdx.x / TCX;
  const int cx = cx0 + tx;
  const int cy = cy0 + ty;
  const bool live = cx < CX && cy < CY;
  int o[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * i + j] = live ? org[(size_t)(4 * cy + i) * W + 4 * cx + j] : 0;
    }
  }
  __syncthreads();
  if (!live) return;

  const int k0 = chunk * OFF_PER_BLOCK;
  const int k1 = min(k0 + OFF_PER_BLOCK, n_off);
  for (int k = k0; k < k1; ++k) {
    const int dx = offsets[2 * k];
    const int dy = offsets[2 * k + 1];
    int acc = 0;
    // an offset beyond the padding reads nothing (the caller passes
    // sr = max |offset|, so this only guards memory)
    if (dx >= -sr && dx <= sr && dy >= -sr && dy <= sr) {
      const int* base = s_win + (sr + 4 * ty + dy) * win_w + (sr + 4 * tx + dx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc += o[4 * i + j] * base[i * win_w + j];
        }
      }
    }
    out[(((size_t)r * n_off + k) * CY + cy) * CX + cx] = acc;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Returns the
// cudaError_t of the launch (0 on success); never synchronises.
extern "C" int cross_cells_launch(const void* org, const void* refs_pad,
                                  const void* offsets, void* out, int H, int W,
                                  int R, int n_off, int sr, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (n_off + OFF_PER_BLOCK - 1) / OFF_PER_BLOCK;
  const int CY = H / 4;
  const int CX = W / 4;
  const size_t smem =
      sizeof(int) * (size_t)(4 * TCY + 2 * sr) * (size_t)(4 * TCX + 2 * sr);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cross_cells_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((CX + TCX - 1) / TCX, (CY + TCY - 1) / TCY, R * n_chunks);
  cross_cells_kernel<<<grid, TCX * TCY, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(org), static_cast<const int*>(refs_pad),
      static_cast<const int*>(offsets), static_cast<int*>(out), H, W, n_off,
      sr, n_chunks);
  return (int)cudaGetLastError();
}
