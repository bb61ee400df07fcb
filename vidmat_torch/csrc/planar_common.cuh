// Shared device code of the planar conv kernels (planar_conv.cu,
// planar_conv2.cu, planar_gru.cu): plane-dtype conversions, staging of
// zero-padded NCHW tiles into shared memory, and the f32 conv accumulation
// over a staged tile.
//
// Layout: every activation is a contiguous NCHW tensor in the plane dtype
// T (__nv_bfloat16 or float). A block owns a th x tw tile of output pixels
// of one image (blockIdx.z) for all output channels. Each stage stages the
// region it reads (the tile plus the halo of every conv that follows) in
// shared memory, channel-major [c][rows][cols], zero outside the image: the
// zero padding of the conv, which the TPU kernels keep as a zero pad ring
// around each plane.
//
// Work inside a stage is a flat list of (pixel, group of CG output
// channels) items spread over the block's threads, pixels fastest, so
// neighbouring threads read neighbouring shared-memory words and write
// neighbouring global addresses. A thread keeps CG f32 accumulators in
// registers. Weights (C_out, C_in, k, k) are read through the read-only
// cache; the threads of a warp read the same weight at once.
//
// Numerics: products of plane-dtype values accumulate in f32 with fmaf
// (a product of two bf16 values is exact in f32, so this equals a separate
// multiply and add); the epilogue `acc * scale + bias` is two rounded
// operations (__fmul_rn, __fadd_rn), as in the JAX kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace planar {

constexpr int kThreads = 256;
constexpr int CG = 8;       // output channels per work item
constexpr int kMaxIn = 3;   // input tensors of one conv (concat operands)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero() {
  return from_f<T>(0.0f);
}

// Up to kMaxIn NCHW tensors of one image size, concatenated along channels.
struct Planes {
  const void* p[kMaxIn];
  int c[kMaxIn];
  int n;
  int total;  // sum of c
};

inline Planes make_planes(const void* const* ptrs, const int* cins, int n_in) {
  Planes pl{};
  pl.n = n_in;
  pl.total = 0;
  for (int i = 0; i < n_in; ++i) {
    pl.p[i] = ptrs[i];
    pl.c[i] = cins[i];
    pl.total += cins[i];
  }
  return pl;
}

// Stages `c` channels of one image (src: (c, h, w) NCHW slice) into
// dst[c][rows][cols] for the region whose top-left pixel is (y0, x0);
// zeros outside the image.
template <typename T>
__device__ void stage(const T* __restrict__ src, int c, int h, int w, int y0,
                      int x0, int rows, int cols, T* dst) {
  const int plane = rows * cols;
  const int total = c * plane;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int ch = i / plane, r = i - ch * plane;
    const int ty = r / cols, tx = r - ty * cols;
    const int gy = y0 + ty, gx = x0 + tx;
    dst[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                 ? src[((long long)ch * h + gy) * w + gx]
                 : zero<T>();
  }
}

// Stages every tensor of `in` (image b) one after another along channels.
template <typename T>
__device__ void stage_planes(const Planes& in, int b, int h, int w, int y0,
                             int x0, int rows, int cols, T* dst) {
  int off = 0;
  for (int i = 0; i < in.n; ++i) {
    const T* src = (const T*)in.p[i] + (long long)b * in.c[i] * h * w;
    stage(src, in.c[i], h, w, y0, x0, rows, cols,
          dst + (long long)off * rows * cols);
    off += in.c[i];
  }
}

// acc[j] += sum over ci < c_src, (ky, kx) < K of
//   src[ci][py + ky][px + kx] * w[co0 + j][ci_off + ci][ky][kx]
// for the j with co0 + j < cout (other lanes read channel cout - 1 and are
// dropped by the caller). w: (cout, w_cin, K, K).
template <typename T, int K>
__device__ __forceinline__ void accum(float (&acc)[CG], const T* src,
                                      int c_src, int rows, int cols, int py,
                                      int px, const T* __restrict__ w,
                                      int w_cin, int ci_off, int co0,
                                      int cout) {
  const T* wrow[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j)
    wrow[j] = w + ((long long)min(co0 + j, cout - 1) * w_cin + ci_off) * K * K;
  const int plane = rows * cols;
  for (int ci = 0; ci < c_src; ++ci) {
    const T* s = src + ci * plane + py * cols + px;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float v = to_f(s[ky * cols + kx]);
        const int t = ci * K * K + ky * K + kx;
#pragma unroll
        for (int j = 0; j < CG; ++j)
          acc[j] = __fmaf_rn(v, to_f(__ldg(wrow[j] + t)), acc[j]);
      }
    }
  }
}

__device__ __forceinline__ float affine(float acc, float scale, float bias,
                                        int relu) {
  const float v = __fadd_rn(__fmul_rn(acc, scale), bias);
  return relu ? fmaxf(v, 0.0f) : v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Shared memory a block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

// Square output tile edge for an (n, h, w) output grid: 16 unless that
// leaves fewer blocks than the card's 132 SMs, then 8, then 4; the
// first edge whose shared memory (smem_of(edge)) fits. 0 if none fits.
template <typename F>
inline int pick_tile(int n, int h, int w, F smem_of) {
  const int edges[3] = {16, 8, 4};
  for (int i = 0; i < 3; ++i) {
    const int t = edges[i];
    const long long blocks =
        (long long)n * ((h + t - 1) / t) * ((w + t - 1) / t);
    if (smem_of(t) > kMaxSmem) continue;
    if (blocks >= 132 || t == 4) return t;
  }
  return 0;
}

inline bool grid_ok(int n, int h, int w, int t) {
  return t > 0 && n >= 1 && n <= 65535 && (h + t - 1) / t <= 65535 && h > 0 &&
         w > 0;
}

}  // namespace planar
