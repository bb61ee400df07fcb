// Multi-input conv + folded-BN affine + activation:
//   out = act(conv_k,stride(concat(xs), w) * scale + bias), cast to T
// k in {1, 3} (zero padding k/2), stride in {1, 2}, up to 3 inputs whose
// concatenation never materializes.
//
// Replaces the TPU kernel vidmat/ops/pallas/planar.py planar_conv
// (_conv_kernel). There each lane chunk of a flattened pitched plane is a
// sum of per-tap MXU matmuls, a stride-2 conv is a 4-tap conv on an
// s2d-repacked plane, and an interior-mask multiply re-zeroes the pad
// ring. Here a block stages the input region of a th x tw output tile
// (plus the conv's halo; stride 2 reads a (2t+1)^2 region) for all input
// channels in shared memory, zero outside the image, and each thread sums
// 9 (or 1) taps x C_in for CG output channels of one pixel in f32
// registers; the stride-2 conv is computed directly.
//
// Main-path sites (1080p, s2d 2, per 4-frame chunk): the stem 12 -> 16,
// stride 2, 144x240 -> 72x120, and the bottleneck 1x1 64 -> 64 at 9x15.
// Bound: the stem reads 3.3 MB and writes 1.1 MB of bf16 per chunk and
// does 60 M multiply-adds, so bytes bound it on this card; this simple CUDA-core
// kernel is limited by its shared-memory and weight loads instead (one of
// each per multiply-add), work for a later tensor-core version.

#include "planar_common.cuh"

namespace {

using namespace planar;

struct Args {
  Planes in;
  const void* w;
  const float* scale;
  const float* bias;
  void* out;
  int h, w_, oh, ow, cout, stride, relu, tile;
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    planar_conv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = (T*)smem_raw;
  const int t = a.tile, s = a.stride, b = blockIdx.z;
  const int oy0 = blockIdx.y * t, ox0 = blockIdx.x * t;
  const int rows = (t - 1) * s + K, cols = rows;
  stage_planes(a.in, b, a.h, a.w_, oy0 * s - K / 2, ox0 * s - K / 2, rows,
               cols, tile);
  __syncthreads();

  const T* w = (const T*)a.w;
  T* out = (T*)a.out + (long long)b * a.cout * a.oh * a.ow;
  const int npix = t * t, groups = (a.cout + CG - 1) / CG;
  for (int item = threadIdx.x; item < npix * groups; item += blockDim.x) {
    const int g = item / npix, p = item - g * npix;
    const int ly = p / t, lx = p - ly * t;
    const int oy = oy0 + ly, ox = ox0 + lx;
    if (oy >= a.oh || ox >= a.ow) continue;
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
    accum<T, K>(acc, tile, a.in.total, rows, cols, ly * s, lx * s, w,
                a.in.total, 0, g * CG, a.cout);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int co = g * CG + j;
      if (co < a.cout)
        out[((long long)co * a.oh + oy) * a.ow + ox] =
            from_f<T>(affine(acc[j], a.scale[co], a.bias[co], a.relu));
    }
  }
}

template <typename T, int K>
cudaError_t launch(Args a, int n, cudaStream_t stream) {
  auto smem_of = [&](int t) {
    const int r = (t - 1) * a.stride + K;
    return (size_t)a.in.total * r * r * sizeof(T);
  };
  a.tile = pick_tile(n, a.oh, a.ow, smem_of);
  if (!grid_ok(n, a.oh, a.ow, a.tile)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(a.tile);
  cudaError_t err = set_smem((const void*)planar_conv_kernel<T, K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ow + a.tile - 1) / a.tile, (a.oh + a.tile - 1) / a.tile,
                  n);
  planar_conv_kernel<T, K><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// xs: n_in pointers to (n, cins[i], h, w); w: (cout, sum cins, k, k);
// scale, bias: (cout,) f32; out: (n, cout, oh, ow) with
// oh = (h + 2*(k/2) - k)/stride + 1. Planes are bf16 (f32 = 0) or f32.
extern "C" int vm_planar_conv(const void* const* xs, const int* cins,
                              int n_in, const void* w, const float* scale,
                              const float* bias, void* out, int n, int h,
                              int w_, int cout, int k, int stride, int relu,
                              int f32, void* stream) {
  if (n_in < 1 || n_in > kMaxIn || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || cout < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in = make_planes(xs, cins, n_in);
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.h = h;
  a.w_ = w_;
  a.oh = (h + 2 * (k / 2) - k) / stride + 1;
  a.ow = (w_ + 2 * (k / 2) - k) / stride + 1;
  a.cout = cout;
  a.stride = stride;
  a.relu = relu;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32)
    return (int)(k == 3 ? launch<float, 3>(a, n, s)
                        : launch<float, 1>(a, n, s));
  return (int)(k == 3 ? launch<__nv_bfloat16, 3>(a, n, s)
                      : launch<__nv_bfloat16, 1>(a, n, s));
}
