// Two chained convs in one launch, the intermediate kept on chip:
//   mid = act(conv3x3,stride(concat(xs), w1) * scale1 + bias1), cast to T,
//         zero outside the image
//   out = act2(conv3x3(mid, w2) * scale2 + bias2), cast to T
//
// Replaces the TPU kernel vidmat/ops/pallas/planar.py planar_conv2
// (_conv2_kernel): conv1 on a halo-extended lane chunk, the interior-mask
// multiply, the cast, then conv2's taps on the in-register mid value.
// Here a block owns a t x t output tile. It stages the input region of the
// (t+2) x (t+2) mid region in shared memory, computes the mid region into
// shared memory in the plane dtype (zero at positions outside the image,
// as the JAX kernel's interior mask makes them: conv1 over the zero
// padding there would give act(bias1), not 0), then computes conv2 over
// it. The mid plane never reaches device memory.
//
// Main-path sites (1080p, s2d 2): the encoder pairs s2a+s2b 16 -> 24 -> 24
// (stride 2, 72x120 -> 36x60), s3 24 -> 40 -> 40 (-> 18x30), s4
// 40 -> 64 -> 64 (-> 9x15), once per 4-frame chunk; and d0 + head
// [12, 12, 12] -> 16 -> 16 at 144x240 (act2 none, scale 1), once per frame.
// Bound: d0 + head moves 3.6 MB of bf16 and does 0.26 G multiply-adds per
// frame, so bytes bound it on this card; this CUDA-core kernel is limited
// by its shared-memory and weight loads, and recomputes the mid halo
// ((t+2)^2 / t^2 of conv1's work).

#include "planar_common.cuh"

namespace {

using namespace planar;

struct Args {
  Planes in;
  const void* w1;
  const float* scale1;
  const float* bias1;
  const void* w2;
  const float* scale2;
  const float* bias2;
  void* out;
  int h, w_, oh, ow, cmid, cout, stride, relu1, relu2, tile;
};

// Both convs are 3x3; the first has stride 1 or 2.
constexpr int K1 = 3;

template <typename T>
__global__ void __launch_bounds__(kThreads) planar_conv2_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = a.tile, s = a.stride, b = blockIdx.z;
  const int oy0 = blockIdx.y * t, ox0 = blockIdx.x * t;
  const int me = t + 2;                     // mid region edge
  const int rows = (me - 1) * s + K1;       // input region edge
  T* in_tile = (T*)smem_raw;
  T* mid = in_tile + (size_t)a.in.total * rows * rows;
  stage_planes(a.in, b, a.h, a.w_, (oy0 - 1) * s - K1 / 2,
               (ox0 - 1) * s - K1 / 2, rows, rows, in_tile);
  __syncthreads();

  // conv1 over the mid region, origin (oy0 - 1, ox0 - 1).
  const int mpix = me * me, mgroups = (a.cmid + CG - 1) / CG;
  for (int item = threadIdx.x; item < mpix * mgroups; item += blockDim.x) {
    const int g = item / mpix, p = item - g * mpix;
    const int ly = p / me, lx = p - ly * me;
    const int my = oy0 - 1 + ly, mx = ox0 - 1 + lx;
    const bool inside = my >= 0 && my < a.oh && mx >= 0 && mx < a.ow;
    float acc[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
    if (inside)
      accum<T, K1>(acc, in_tile, a.in.total, rows, rows, ly * s, lx * s,
                   (const T*)a.w1, a.in.total, 0, g * CG, a.cmid);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int c = g * CG + j;
      if (c < a.cmid)
        mid[c * mpix + p] =
            inside ? from_f<T>(affine(acc[j], a.scale1[c], a.bias1[c],
                                      a.relu1))
                   : zero<T>();
    }
  }
  __syncthreads();

  // conv2 (3x3) over the mid region -> the t x t output tile.
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
    accum<T, 3>(acc, mid, a.cmid, me, me, ly, lx, (const T*)a.w2, a.cmid, 0,
                g * CG, a.cout);
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int co = g * CG + j;
      if (co < a.cout)
        out[((long long)co * a.oh + oy) * a.ow + ox] =
            from_f<T>(affine(acc[j], a.scale2[co], a.bias2[co], a.relu2));
    }
  }
}

template <typename T>
cudaError_t launch(Args a, int n, cudaStream_t stream) {
  auto smem_of = [&](int t) {
    const int me = t + 2, r = (me - 1) * a.stride + K1;
    return ((size_t)a.in.total * r * r + (size_t)a.cmid * me * me) *
           sizeof(T);
  };
  a.tile = pick_tile(n, a.oh, a.ow, smem_of);
  if (!grid_ok(n, a.oh, a.ow, a.tile)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(a.tile);
  cudaError_t err = set_smem((const void*)planar_conv2_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ow + a.tile - 1) / a.tile, (a.oh + a.tile - 1) / a.tile,
                  n);
  planar_conv2_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// xs: n_in pointers to (n, cins[i], h, w); w1: (cmid, sum cins, 3, 3);
// w2: (cout, cmid, 3, 3); scale/bias: f32 per output channel; out:
// (n, cout, oh, ow), oh = (h - 1)/stride + 1. relu1/relu2
// select the activations. Planes are bf16 (f32 = 0) or f32.
extern "C" int vm_planar_conv2(const void* const* xs, const int* cins,
                               int n_in, const void* w1, const float* scale1,
                               const float* bias1, const void* w2,
                               const float* scale2, const float* bias2,
                               void* out, int n, int h, int w_, int cmid,
                               int cout, int stride, int relu1,
                               int relu2, int f32, void* stream) {
  if (n_in < 1 || n_in > kMaxIn || (stride != 1 && stride != 2) ||
      cmid < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in = make_planes(xs, cins, n_in);
  a.w1 = w1;
  a.scale1 = scale1;
  a.bias1 = bias1;
  a.w2 = w2;
  a.scale2 = scale2;
  a.bias2 = bias2;
  a.out = out;
  a.h = h;
  a.w_ = w_;
  a.oh = (h - 1) / stride + 1;
  a.ow = (w_ - 1) / stride + 1;
  a.cmid = cmid;
  a.cout = cout;
  a.stride = stride;
  a.relu1 = relu1;
  a.relu2 = relu2;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return (int)launch<float>(a, n, s);
  return (int)launch<__nv_bfloat16>(a, n, s);
}
