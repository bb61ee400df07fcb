// int8-stored 3x3 conv probe, 16 -> 16 channels, NCHW:
//   xb    = bf16(bf16(x) * bf16(1 / q))          dequantize each input
//   acc   = sum over (ci, ky, kx) of xb * w      bf16 products, f32 sums
//   out   = clip(round(max(acc, 0) * q), -127, 127) as int8
// with zero padding outside the image and round half to even
// (__float2int_rn, as jnp.round).
//
// Replaces the TPU kernel of tools/bench_int8_planes.py (int8_conv, its
// int8_kernel): a measurement of whether int8-stored activation planes
// would speed up the planar net. The TPU kernel reads pitched (C, TOTAL)
// int8 planes with a zero ring and masks the ring on output; here the
// planes are NCHW and the ring is the implicit zero padding of the tile
// load. A block stages its output tile plus a one-pixel halo of all 16
// input channels, dequantized, in shared memory, and every weight as
// float; each thread computes the 16 output channels of one pixel on the
// CUDA cores (a simple kernel, no tensor cores).
//
// Bound: bytes. At the probe's shape (8 x 16 x 144 x 240) 4.4 MB of int8
// read and 4.4 MB written: 2.6 us at 3.35 TB/s; its 1.27 GFLOP is 1.3 us
// of bf16 tensor-core peak. Built with --fmad=false; every product of two
// bf16 values is exact in float32, so only the order of the sums differs
// from the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;       // input and output channels
constexpr int TW = 32;      // output tile width (threadIdx.x)
constexpr int TH = 8;       // output tile height (threadIdx.y)
constexpr int SW = TW + 2;  // staged tile with its halo
constexpr int SH = TH + 2;

__global__ void __launch_bounds__(TW * TH)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     int8_t* __restrict__ out, int h, int wd, float scale,
                     float q) {
  __shared__ float xs[C][SH][SW];
  __shared__ float ws[C * 9][C];  // [ci * 9 + tap][co]
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;

  for (int i = tid; i < C * C * 9; i += TW * TH) {
    const int co = i / (C * 9), rest = i % (C * 9);  // w is (co, ci, ky, kx)
    ws[rest][co] = __bfloat162float(w[i]);
  }
  const int8_t* xb = x + (long long)b * C * h * wd;
  for (int i = tid; i < C * SH * SW; i += TW * TH) {
    const int ci = i / (SH * SW), r = (i / SW) % SH, c = i % SW;
    const int gy = y0 + r - 1, gx = x0 + c - 1;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
      v = __bfloat162float(__float2bfloat16_rn(
          (float)xb[((long long)ci * h + gy) * wd + gx] * scale));
    xs[ci][r][c] = v;
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx >= wd || gy >= h) return;
  float acc[C];
#pragma unroll
  for (int co = 0; co < C; ++co) acc[co] = 0.0f;
  for (int ci = 0; ci < C; ++ci) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float v = xs[ci][ty + t / 3][tx + t % 3];
      const float* wr = ws[ci * 9 + t];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] += v * wr[co];
    }
  }
  int8_t* ob = out + (long long)b * C * h * wd + (long long)gy * wd + gx;
#pragma unroll
  for (int co = 0; co < C; ++co) {
    int v = __float2int_rn(fmaxf(acc[co], 0.0f) * q);
    v = min(max(v, -127), 127);
    ob[(long long)co * h * wd] = (int8_t)v;
  }
}

}  // namespace

// x, out: (n, 16, h, w) int8; w: (16, 16, 3, 3) bf16; scale: the bf16
// value of 1 / q (the dequantization factor); q: the requantization
// factor.
extern "C" int vm_int8_conv(const void* x, const void* w, void* out, int n,
                            int h, int wd, float scale, float q,
                            void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || n > 65535 || (h + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n);
  int8_conv_kernel<<<grid, dim3(TW, TH), 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const __nv_bfloat16*)w, (int8_t*)out, h, wd, scale,
      q);
  return (int)cudaGetLastError();
}
