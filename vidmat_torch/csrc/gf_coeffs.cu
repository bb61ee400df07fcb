// Fast guided-filter coefficients at the coarse grid:
//   mean_I, corr_II, mean_p, corr_Ip  = (2r+1)^2 edge-truncated box means
//   a = (corr_Ip - mean_I*mean_p) / (corr_II - mean_I^2 + eps)
//   b = mean_p - a*mean_I
//   out = box_mean(a), box_mean(b)
// for one shared guide I and four signals p = [alpha, r, g, b].
//
// Replaces the TPU kernel vidmat/ops/pallas/gf_kernel.py
// guided_filter_coeffs (_gf_kernel, and _gf_kernel_perchannel, its
// per-channel variant of the same math). The TPU kernel computes the box
// sums as banded matmuls over the whole grid held in VMEM; here two
// launches tile the grid into 32x8 output blocks:
//   gf_ab_kernel:  a tile of I and p with an r-pixel halo in shared
//                  memory -> column sums of the 10 statistics (I, I^2,
//                  p[4], I*p[4]; the guide's two are shared across the
//                  four channels) -> row sums -> a, b (8 f32 per pixel,
//                  written to a scratch grid)
//   gf_box_kernel: the same tiled box mean over the 8 a/b channels.
//
// Bound: bytes. At 272x480: 2.6 MB read (guide + p), 4.2 MB written
// (mean_a, mean_b); the a/b scratch adds 4.2 MB written and read back.
// The arithmetic (~45 flops per pixel per statistic) is far below the
// card's f32 rate.
//
// Summation order matches the plain PyTorch version
// (vidmat_torch/ops/guided_filter.py box_sum): zero padding, the 2r+1
// rows added in ascending order starting from 0, then the 2r+1 columns.
// Built with --fmad=false, so products and sums round as separate
// operations, as they do there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int kThreads = TX * TY;

__device__ __forceinline__ float inv_count(int y, int x, int h, int w,
                                           int r) {
  const int ch = min(y + r, h - 1) - max(y - r, 0) + 1;
  const int cw = min(x + r, w - 1) - max(x - r, 0) + 1;
  return 1.0f / (float)(ch * cw);
}

// Loads the (TY+2r) x (TX+2r) halo tile of NC channels (channel-minor
// source rows of `stride` floats, channels [c0, c0+NC)) into `tile`
// (channel-major), zeros outside the image.
template <int NC>
__device__ void load_tile(const float* __restrict__ src, int stride, int c0,
                          int h, int w, int y0, int x0, int r, float* tile) {
  const int rows = TY + 2 * r, cols = TX + 2 * r, plane = rows * cols;
  for (int i = threadIdx.y * TX + threadIdx.x; i < plane; i += kThreads) {
    const int ty = i / cols, tx = i % cols;
    const int gy = y0 - r + ty, gx = x0 - r + tx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float* px = src + ((long long)gy * w + gx) * stride + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) tile[c * plane + i] = in ? px[c] : 0.0f;
  }
}

// Pass 1: statistics -> a, b.
__global__ void gf_ab_kernel(const float* __restrict__ guide,
                             const float* __restrict__ p,
                             float* __restrict__ ab, int h, int w, int r,
                             float eps) {
  extern __shared__ float smem[];
  const int rows = TY + 2 * r, cols = TX + 2 * r, plane = rows * cols;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  float* tile = smem;                 // [5][rows][cols]: I, p0..p3
  float* colsum = smem + 5 * plane;   // [10][TY][cols]
  const int cplane = TY * cols;

  load_tile<1>(guide + (long long)b * h * w, 1, 0, h, w, y0, x0, r, tile);
  load_tile<4>(p + (long long)b * h * w * 4, 4, 0, h, w, y0, x0, r,
               tile + plane);
  __syncthreads();

  // Column sums over the 2r+1 rows of each output row, for every tile
  // column (halo columns included).
  for (int i = threadIdx.y * TX + threadIdx.x; i < cplane; i += kThreads) {
    const int vy = i / cols, vx = i % cols;
    float s[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) s[k] = 0.0f;
    for (int d = 0; d <= 2 * r; ++d) {
      const int t = (vy + d) * cols + vx;
      const float I = tile[t];
      s[0] += I;
      s[1] += I * I;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pc = tile[(1 + c) * plane + t];
        s[2 + c] += pc;
        s[6 + c] += I * pc;
      }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) colsum[k * cplane + i] = s[k];
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= h || x >= w) return;
  float s[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) s[k] = 0.0f;
  for (int d = 0; d <= 2 * r; ++d) {
    const int t = threadIdx.y * cols + threadIdx.x + d;
#pragma unroll
    for (int k = 0; k < 10; ++k) s[k] += colsum[k * cplane + t];
  }
  const float inv_n = inv_count(y, x, h, w, r);
  const float mean_I = s[0] * inv_n;
  const float corr_II = s[1] * inv_n;
  const float var_I = corr_II - mean_I * mean_I;
  float* out = ab + (((long long)b * h + y) * w + x) * 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float mean_p = s[2 + c] * inv_n;
    const float corr_Ip = s[6 + c] * inv_n;
    const float cov_Ip = corr_Ip - mean_I * mean_p;
    const float a = cov_Ip / (var_I + eps);
    out[c] = a;
    out[4 + c] = mean_p - a * mean_I;
  }
}

// Pass 2: box means of the 8 a/b channels -> mean_a, mean_b.
__global__ void gf_box_kernel(const float* __restrict__ ab,
                              float* __restrict__ mean_a,
                              float* __restrict__ mean_b, int h, int w,
                              int r) {
  extern __shared__ float smem[];
  const int rows = TY + 2 * r, cols = TX + 2 * r, plane = rows * cols;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  float* tile = smem;                 // [8][rows][cols]
  float* colsum = smem + 8 * plane;   // [8][TY][cols]
  const int cplane = TY * cols;

  load_tile<8>(ab + (long long)b * h * w * 8, 8, 0, h, w, y0, x0, r, tile);
  __syncthreads();

  for (int i = threadIdx.y * TX + threadIdx.x; i < cplane; i += kThreads) {
    const int vy = i / cols, vx = i % cols;
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = 0.0f;
    for (int d = 0; d <= 2 * r; ++d) {
      const int t = (vy + d) * cols + vx;
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] += tile[k * plane + t];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) colsum[k * cplane + i] = s[k];
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= h || x >= w) return;
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0f;
  for (int d = 0; d <= 2 * r; ++d) {
    const int t = threadIdx.y * cols + threadIdx.x + d;
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += colsum[k * cplane + t];
  }
  const float inv_n = inv_count(y, x, h, w, r);
  const long long o = (((long long)b * h + y) * w + x) * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mean_a[o + c] = s[c] * inv_n;
    mean_b[o + c] = s[4 + c] * inv_n;
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// guide: (n, h, w) f32; p: (n, h, w, 4) f32; ab: (n, h, w, 8) f32 scratch;
// mean_a, mean_b: (n, h, w, 4) f32.
extern "C" int vm_gf_coeffs(const void* guide, const void* p, void* ab,
                            void* mean_a, void* mean_b, int n, int h, int w,
                            int r, float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || r < 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(TX, TY);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, n);
  const int cols = TX + 2 * r, plane = (TY + 2 * r) * cols;
  const size_t smem_ab = (size_t)(5 * plane + 10 * TY * cols) * 4;
  const size_t smem_box = (size_t)(8 * plane + 8 * TY * cols) * 4;
  cudaError_t err = set_smem((const void*)gf_ab_kernel, smem_ab);
  if (err != cudaSuccess) return (int)err;
  err = set_smem((const void*)gf_box_kernel, smem_box);
  if (err != cudaSuccess) return (int)err;
  gf_ab_kernel<<<grid, block, smem_ab, s>>>(
      (const float*)guide, (const float*)p, (float*)ab, h, w, r, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gf_box_kernel<<<grid, block, smem_box, s>>>(
      (const float*)ab, (float*)mean_a, (float*)mean_b, h, w, r);
  return (int)cudaGetLastError();
}
