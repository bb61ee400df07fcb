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
// sums as banded matmuls over the whole grid held in VMEM. Here one launch
// tiles the grid into TX x TY output blocks, and a block keeps every
// intermediate in shared memory:
//   stage 0: I and p over the tile plus a 2r halo (one float and one
//            float4 per pixel), zero outside the image;
//   stage 1: column sums over 2r+1 rows of the 10 statistics (I, I^2,
//            p[4], I*p[4]) on the tile plus an r halo of rows, for every
//            staged column;
//   stage 2: row sums over 2r+1 columns, then a and b on the tile plus an
//            r halo (zero outside the image, as the plain version's zero
//            padding makes them);
//   stage 3, 4: the same box sums over the 8 a/b channels, scaled and
//            written as one float4 of mean_a and one of mean_b per pixel.
// a and b on the halo are recomputed by the neighbouring blocks too: a
// little arithmetic in place of an (n, h, w, 8) scratch grid written and
// read back and a second launch. Stages 0 and 2 share one buffer, stages 1
// and 3 another. A thread sums a strip of neighbouring outputs from one
// window of values it loads once (compile-time radius R, so the window
// stays in registers).
//
// Bound: bytes. At 272x480 per frame: 2.6 MB read (guide + p), 4.2 MB
// written (mean_a, mean_b); the arithmetic (~300 adds per pixel, 2r+1 = 9)
// is a third of that time at the card's f32 rate.
//
// Summation order matches the plain PyTorch version
// (vidmat_torch/ops/guided_filter.py box_sum): zero padding, the 2r+1
// rows added in ascending order starting from the first, then the 2r+1
// columns; no running-window sums. Built with --fmad=false, so products
// and sums round as separate operations, as they do there: the kernel is
// bit-exact to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // output tile columns
constexpr int TY = 16;  // output tile rows
constexpr int kThreads = 256;
constexpr int kMaxRadius = 8;

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
// An odd row stride of at least n floats: a warp's strips of neighbouring
// rows fall in different banks.
__host__ __device__ constexpr int odd(int n) { return n | 1; }

// The block's shared-memory layout for radius R, in floats.
template <int R>
struct Geo {
  static constexpr int EH = TY + 4 * R, EW = TX + 4 * R;  // staged I, p
  static constexpr int VH = TY + 2 * R;                  // rows of a, b
  static constexpr int AW = TX + 2 * R;                  // columns of a, b
  static constexpr int VS = odd(EW), AS = odd(AW);       // row strides
  static constexpr int kStaged = 5 * EH * EW;            // I, p[4]
  static constexpr int kAB = 8 * VH * AS;                // a[4], b[4]
  static constexpr int kCols = 10 * VH * VS;             // stage 1
  static constexpr int kCols2 = 8 * TY * AS;             // stage 3
  static constexpr int kBufA = kStaged > kAB ? kStaged : kAB;
  static constexpr int kBufB = kCols > kCols2 ? kCols : kCols2;
  static constexpr size_t kBytes = (size_t)(kBufA + kBufB) * sizeof(float);
  // Strips: rows per thread in stages 1 and 3, columns in 2 and 4, so
  // that one pass of the block's threads covers each stage.
  static constexpr int S1 = cdiv(VH, kThreads / EW);
  static constexpr int S2 = cdiv(AW, kThreads / VH);
  static constexpr int S3 = cdiv(TY, kThreads / AW);
  static constexpr int S4 = cdiv(TX, kThreads / TY);
};

__device__ __forceinline__ float inv_count(int y, int x, int h, int w,
                                           int r) {
  const int ch = min(y + r, h - 1) - max(y - r, 0) + 1;
  const int cw = min(x + r, w - 1) - max(x - r, 0) + 1;
  return 1.0f / (float)(ch * cw);
}

// The window v[i] = src[i * step] of a strip of n <= S outputs (zero past
// n + 2R).
template <int R, int S>
__device__ __forceinline__ void load_strip(const float* src, int step, int n,
                                           float (&v)[S + 2 * R]) {
#pragma unroll
  for (int i = 0; i < S + 2 * R; ++i)
    v[i] = i < n + 2 * R ? src[i * step] : 0.0f;
}

// out[j] = v[j] + v[j + 1] + ... + v[j + 2R], added in that order.
template <int R, int S>
__device__ __forceinline__ void box_sums(const float (&v)[S + 2 * R],
                                         float (&out)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float s = v[j];
#pragma unroll
    for (int d = 1; d <= 2 * R; ++d) s = __fadd_rn(s, v[j + d]);
    out[j] = s;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    gf_kernel(const float* __restrict__ guide, const float4* __restrict__ p,
              float4* __restrict__ mean_a, float4* __restrict__ mean_b,
              int h, int w, float eps) {
  using G = Geo<R>;
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;
  float* buf_b = smem + G::kBufA;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.x;
  const long long img = (long long)b * h * w;

  // Stage 0: I and p on rows [y0 - 2R, y0 + TY + 2R), columns
  // [x0 - 2R, x0 + TX + 2R), channel-planar.
  {
    float* sI = buf_a;
    float* sP = buf_a + G::EH * G::EW;
    constexpr int plane = G::EH * G::EW;
    for (int i = tid; i < plane; i += kThreads) {
      const int ry = i / G::EW, rx = i - ry * G::EW;
      const int gy = y0 - 2 * R + ry, gx = x0 - 2 * R + rx;
      float I = 0.0f;
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const long long o = img + (long long)gy * w + gx;
        I = __ldg(guide + o);
        q = __ldg(p + o);
      }
      sI[i] = I;
      sP[i] = q.x;
      sP[plane + i] = q.y;
      sP[2 * plane + i] = q.z;
      sP[3 * plane + i] = q.w;
    }
  }
  __syncthreads();

  // Stage 1: column sums of the 10 statistics on rows [y0 - R, y0 + TY +
  // R) (V rows) for every staged column.
  {
    const float* sI = buf_a;
    const float* sP = buf_a + G::EH * G::EW;
    float* cs = buf_b;  // [10][VH][VS]
    constexpr int strips = cdiv(G::VH, G::S1);
    for (int item = tid; item < strips * G::EW; item += kThreads) {
      const int st = item / G::EW, x = item - st * G::EW;
      const int v0 = st * G::S1, n = min(G::S1, G::VH - v0);
      float I[G::S1 + 2 * R], I2[G::S1 + 2 * R];
#pragma unroll
      for (int i = 0; i < G::S1 + 2 * R; ++i) {
        I[i] = i < n + 2 * R ? sI[(v0 + i) * G::EW + x] : 0.0f;
        I2[i] = __fmul_rn(I[i], I[i]);
      }
      float out[G::S1];
      auto put = [&](int k) {
#pragma unroll
        for (int j = 0; j < G::S1; ++j)
          if (j < n) cs[(k * G::VH + v0 + j) * G::VS + x] = out[j];
      };
      box_sums<R>(I, out);
      put(0);
      box_sums<R>(I2, out);
      put(1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* pc = sP + c * G::EH * G::EW;
        float P[G::S1 + 2 * R], IP[G::S1 + 2 * R];
#pragma unroll
        for (int i = 0; i < G::S1 + 2 * R; ++i) {
          P[i] = i < n + 2 * R ? pc[(v0 + i) * G::EW + x] : 0.0f;
          IP[i] = __fmul_rn(I[i], P[i]);
        }
        box_sums<R>(P, out);
        put(2 + c);
        box_sums<R>(IP, out);
        put(6 + c);
      }
    }
  }
  __syncthreads();

  // Stage 2: row sums on columns [x0 - R, x0 + TX + R), then a and b there
  // (zero outside the image) into buf_a: [8][VH][AS].
  {
    const float* cs = buf_b;
    float* ab = buf_a;
    constexpr int strips = cdiv(G::AW, G::S2);
    for (int item = tid; item < strips * G::VH; item += kThreads) {
      const int v = item / strips, x0s = (item - v * strips) * G::S2;
      const int n = min(G::S2, G::AW - x0s);
      float s[10][G::S2];
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        float win[G::S2 + 2 * R];
        load_strip<R, G::S2>(cs + (k * G::VH + v) * G::VS + x0s, 1, n, win);
        box_sums<R>(win, s[k]);
      }
      const int gy = y0 - R + v;
#pragma unroll
      for (int j = 0; j < G::S2; ++j) {
        if (j >= n) break;
        const int gx = x0 - R + x0s + j;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
        const float inv_n = inside ? inv_count(gy, gx, h, w, R) : 0.0f;
        const float mean_I = __fmul_rn(s[0][j], inv_n);
        const float corr_II = __fmul_rn(s[1][j], inv_n);
        const float var_I = __fsub_rn(corr_II, __fmul_rn(mean_I, mean_I));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = 0.0f, bb = 0.0f;
          if (inside) {
            const float mean_p = __fmul_rn(s[2 + c][j], inv_n);
            const float corr_Ip = __fmul_rn(s[6 + c][j], inv_n);
            const float cov_Ip =
                __fsub_rn(corr_Ip, __fmul_rn(mean_I, mean_p));
            a = __fdiv_rn(cov_Ip, __fadd_rn(var_I, eps));
            bb = __fsub_rn(mean_p, __fmul_rn(a, mean_I));
          }
          ab[(c * G::VH + v) * G::AS + x0s + j] = a;
          ab[((4 + c) * G::VH + v) * G::AS + x0s + j] = bb;
        }
      }
    }
  }
  __syncthreads();

  // Stage 3: column sums of a and b on the tile's rows, every column of
  // the a/b region, into buf_b: [8][TY][AS].
  {
    const float* ab = buf_a;
    float* cs = buf_b;
    constexpr int strips = cdiv(TY, G::S3);
    for (int item = tid; item < strips * G::AW; item += kThreads) {
      const int st = item / G::AW, x = item - st * G::AW;
      const int r0 = st * G::S3, n = min(G::S3, TY - r0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float win[G::S3 + 2 * R], out[G::S3];
        load_strip<R, G::S3>(ab + (k * G::VH + r0) * G::AS + x, G::AS, n,
                             win);
        box_sums<R>(win, out);
#pragma unroll
        for (int j = 0; j < G::S3; ++j)
          if (j < n) cs[(k * TY + r0 + j) * G::AS + x] = out[j];
      }
    }
  }
  __syncthreads();

  // Stage 4: row sums on the tile, scaled, one float4 of mean_a and one of
  // mean_b per pixel.
  {
    const float* cs = buf_b;
    constexpr int strips = cdiv(TX, G::S4);
    for (int item = tid; item < strips * TY; item += kThreads) {
      const int ty = item / strips, xs = (item - ty * strips) * G::S4;
      const int y = y0 + ty;
      if (y >= h) continue;
      const int n = min(G::S4, TX - xs);
      float s[8][G::S4];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float win[G::S4 + 2 * R];
        load_strip<R, G::S4>(cs + (k * TY + ty) * G::AS + xs, 1, n, win);
        box_sums<R>(win, s[k]);
      }
#pragma unroll
      for (int j = 0; j < G::S4; ++j) {
        const int x = x0 + xs + j;
        if (j >= n || x >= w) break;
        const float inv_n = inv_count(y, x, h, w, R);
        const long long o = img + (long long)y * w + x;
        mean_a[o] = make_float4(
            __fmul_rn(s[0][j], inv_n), __fmul_rn(s[1][j], inv_n),
            __fmul_rn(s[2][j], inv_n), __fmul_rn(s[3][j], inv_n));
        mean_b[o] = make_float4(
            __fmul_rn(s[4][j], inv_n), __fmul_rn(s[5][j], inv_n),
            __fmul_rn(s[6][j], inv_n), __fmul_rn(s[7][j], inv_n));
      }
    }
  }
}

template <int R>
cudaError_t launch(const float* guide, const float4* p, float4* mean_a,
                   float4* mean_b, int n, int h, int w, float eps,
                   cudaStream_t stream) {
  const size_t smem = Geo<R>::kBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)gf_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(cdiv(w, TX), cdiv(h, TY), n);
  gf_kernel<R><<<grid, kThreads, smem, stream>>>(guide, p, mean_a, mean_b, h,
                                                 w, eps);
  return cudaGetLastError();
}

}  // namespace

// guide: (n, h, w) f32; p: (n, h, w, 4) f32; mean_a, mean_b: (n, h, w, 4)
// f32; p and the outputs 16-byte aligned. r in [0, 8] (the radii whose
// block fits in shared memory); other radii, and grids the launch cannot
// cover, return cudaErrorInvalidValue.
extern "C" int vm_gf_coeffs(const void* guide, const void* p, void* mean_a,
                            void* mean_b, int n, int h, int w, int r,
                            float eps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || r < 0 || r > kMaxRadius || n > 65535 ||
      cdiv(h, TY) > 65535 ||
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(mean_a) |
        reinterpret_cast<uintptr_t>(mean_b)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)guide;
  const float4* pp = (const float4*)p;
  float4* ma = (float4*)mean_a;
  float4* mb = (float4*)mean_b;
  switch (r) {
    case 0: return (int)launch<0>(g, pp, ma, mb, n, h, w, eps, s);
    case 1: return (int)launch<1>(g, pp, ma, mb, n, h, w, eps, s);
    case 2: return (int)launch<2>(g, pp, ma, mb, n, h, w, eps, s);
    case 3: return (int)launch<3>(g, pp, ma, mb, n, h, w, eps, s);
    case 4: return (int)launch<4>(g, pp, ma, mb, n, h, w, eps, s);
    case 5: return (int)launch<5>(g, pp, ma, mb, n, h, w, eps, s);
    case 6: return (int)launch<6>(g, pp, ma, mb, n, h, w, eps, s);
    case 7: return (int)launch<7>(g, pp, ma, mb, n, h, w, eps, s);
    default: return (int)launch<8>(g, pp, ma, mb, n, h, w, eps, s);
  }
}
