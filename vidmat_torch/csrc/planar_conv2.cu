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
// bf16 planes (the serving path) run on the tensor cores
// (planar_mma.cuh): the input region and the mid region are staged
// channels-last, both convs' weights are reordered into [n][tap][k] in
// shared memory by the block, and each conv is an implicit GEMM over
// mma.sync.m16n8k16. The tile edge (16, 8 or 4) is the one of least
// estimated time whose shared memory fits (mma::plan_tile). f32 planes
// are the parity instantiation: CUDA-core f32 FMAs (exact products, the
// 1e-5 bar), tile picked by pick_tile.
//
// Main-path sites (1080p, s2d 2): the encoder pairs s2a+s2b 16 -> 24 -> 24
// (stride 2, 72x120 -> 36x60), s3 24 -> 40 -> 40 (-> 18x30), s4
// 40 -> 64 -> 64 (-> 9x15), once per 4-frame chunk; and d0 + head
// [12, 12, 12] -> 16 -> 16 at 144x240 (act2 none, scale 1), once per frame.
// Bound: d0 + head moves 3.6 MB of bf16 and does 0.26 G multiply-adds per
// frame, so bytes bound it on this card; what the kernel spends goes to
// staging (device-memory latency) and to ldmatrix traffic in shared memory,
// and the mid halo is recomputed ((t+2)^2 / t^2 of conv1's work).

#include "planar_mma.cuh"

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

// f32 planes: CUDA-core FMAs (the parity instantiation).
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

cudaError_t launch_f32(Args a, int n, cudaStream_t stream) {
  auto smem_of = [&](int t) {
    const int me = t + 2, r = (me - 1) * a.stride + K1;
    return ((size_t)a.in.total * r * r + (size_t)a.cmid * me * me) *
           sizeof(float);
  };
  a.tile = pick_tile(n, a.oh, a.ow, smem_of);
  if (!grid_ok(n, a.oh, a.ow, a.tile)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(a.tile);
  cudaError_t err = set_smem((const void*)planar_conv2_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ow + a.tile - 1) / a.tile, (a.oh + a.tile - 1) / a.tile,
                  n);
  planar_conv2_kernel<float><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- bf16 planes: tensor cores ----

using mma::bf16;

// Shared memory of the bf16 kernel, in bf16 elements from the start:
// input region [rows^2][ps_in], mid region [me^2][ps_mid], w1 [cmid][9 *
// cinp], w2 [cout][9 * cmidp] (staged layouts of planar_mma.cuh), the
// warps' recompute queues.
struct Layout {
  int me, rows, cinp, cmidp, ps_in, ps_mid;
  size_t in, mid, w1, w2, queue, total;  // offsets; total in elements

  __host__ __device__ Layout(int cin, int cmid, int cout, int stride,
                             int t) {
    me = t + 2;
    rows = (me - 1) * stride + K1;
    cinp = mma::up(cin, 16);
    cmidp = mma::up(cmid, 16);
    ps_in = mma::pstride(cin);
    ps_mid = mma::pstride(cmid);
    in = 0;
    mid = in + (size_t)rows * rows * ps_in;
    w1 = mid + (size_t)me * me * ps_mid;
    w2 = w1 + mma::welems(cmid, cinp);
    queue = w2 + mma::welems(cout, cmidp);
    total = queue + mma::kQueueBytes / sizeof(bf16);
  }
};

__global__ void __launch_bounds__(kThreads)
    planar_conv2_kernel_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = (bf16*)smem_raw;
  const int t = a.tile, s = a.stride, b = blockIdx.z;
  const int oy0 = blockIdx.y * t, ox0 = blockIdx.x * t;
  const Layout L(a.in.total, a.cmid, a.cout, s, t);
  bf16* in = sm + L.in;
  bf16* mid = sm + L.mid;
  bf16* w1 = sm + L.w1;
  bf16* w2 = sm + L.w2;

  mma::stage_cl(a.in, b, a.h, a.w_, (oy0 - 1) * s - K1 / 2,
                (ox0 - 1) * s - K1 / 2, L.rows, L.rows, in, L.ps_in, 0,
                L.cinp);
  mma::stage_w((const bf16*)a.w1, a.cmid, a.in.total, L.cinp, a.in.total,
               a.in.total, w1);
  mma::stage_w((const bf16*)a.w2, a.cout, a.cmid, L.cmidp, a.cmid, a.cmid,
               w2);
  // Mid channels past the last N tile: conv2 reads them as zeros.
  mma::zero_cl(mid, L.me * L.me, L.ps_mid, mma::up(a.cmid, 8), L.cmidp);
  __syncthreads();

  unsigned* queue = (unsigned*)(sm + L.queue);

  // conv1 over the mid region, origin (oy0 - 1, ox0 - 1); channels in
  // [cmid, up(cmid, 8)) are written as zeros.
  {
    const mma::Seg segs[1] = {
        {in, L.rows, L.ps_in, 0, L.cinp / 16, 0, a.in.total}};
    const int me = L.me;
    auto put = [&](int m, int c, float v) {
      mid[(size_t)m * L.ps_mid + c] = __float2bfloat16_rn(v);
    };
    mma::conv_stage(
        segs, s, me, me, w1, L.cinp, a.cmid, queue,
        [&](int m, int c, float acc, float e) {
          const int ly = m / me, lx = m - ly * me;
          const int my = oy0 - 1 + ly, mx = ox0 - 1 + lx;
          float v = 0.0f;
          if (my >= 0 && my < a.oh && mx >= 0 && mx < a.ow && c < a.cmid &&
              !mma::affine_checked(acc, e, a.scale1[c], a.bias1[c],
                                   a.relu1, &v))
            return false;
          put(m, c, v);
          return true;
        },
        [&](int m, int c) {
          put(m, c, affine(mma::seq_sum(segs, s, me, m, w1, L.cinp, c),
                           a.scale1[c], a.bias1[c], a.relu1));
        });
  }
  __syncthreads();

  // conv2 (3x3) over the mid region -> the t x t output tile.
  {
    const mma::Seg segs[1] = {
        {mid, L.me, L.ps_mid, 0, L.cmidp / 16, 0, a.cmid}};
    bf16* out = (bf16*)a.out + (long long)b * a.cout * a.oh * a.ow;
    auto put = [&](int m, int c, float v) {
      const int ly = m / t, lx = m - ly * t;
      out[((long long)c * a.oh + oy0 + ly) * a.ow + ox0 + lx] =
          __float2bfloat16_rn(v);
    };
    mma::conv_stage(
        segs, 1, t, t, w2, L.cmidp, a.cout, queue,
        [&](int m, int c, float acc, float e) {
          const int ly = m / t, lx = m - ly * t;
          if (c >= a.cout || oy0 + ly >= a.oh || ox0 + lx >= a.ow)
            return true;
          float v;
          if (!mma::affine_checked(acc, e, a.scale2[c], a.bias2[c],
                                   a.relu2, &v))
            return false;
          put(m, c, v);
          return true;
        },
        [&](int m, int c) {
          put(m, c, affine(mma::seq_sum(segs, 1, t, m, w2, L.cmidp, c),
                           a.scale2[c], a.bias2[c], a.relu2));
        });
  }
}

mma::Plan plan_bf16(const Args& a, int n) {
  auto smem_of = [&](int t) {
    return Layout(a.in.total, a.cmid, a.cout, a.stride, t).total *
           sizeof(bf16);
  };
  auto work_of = [&](int t) {
    const Layout L(a.in.total, a.cmid, a.cout, a.stride, t);
    const double staged = (double)L.rows * L.rows * L.cinp +
                          9.0 * a.cmid * a.in.total + 9.0 * a.cout * a.cmid;
    return mma::staging_work(staged) +
           mma::stage_work(L.me * L.me, a.cmid, L.cinp) +
           mma::stage_work(t * t, a.cout, L.cmidp);
  };
  return mma::plan_tile(n, a.oh, a.ow, smem_of, work_of);
}

cudaError_t launch_bf16(Args a, int n, cudaStream_t stream) {
  const mma::Plan p = plan_bf16(a, n);
  a.tile = p.tile;
  if (!grid_ok(n, a.oh, a.ow, a.tile)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)planar_conv2_kernel_mma, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ow + a.tile - 1) / a.tile, (a.oh + a.tile - 1) / a.tile,
                  n);
  planar_conv2_kernel_mma<<<grid, kThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

bool make_args(Args& a, const void* const* xs, const int* cins, int n_in,
               int h, int w_, int cmid, int cout, int stride) {
  if (n_in < 1 || n_in > kMaxIn || (stride != 1 && stride != 2) ||
      cmid < 1 || cout < 1)
    return false;
  a = Args{};
  a.in = make_planes(xs, cins, n_in);
  a.h = h;
  a.w_ = w_;
  a.oh = (h - 1) / stride + 1;
  a.ow = (w_ - 1) / stride + 1;
  a.cmid = cmid;
  a.cout = cout;
  a.stride = stride;
  return true;
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
  Args a;
  if (!make_args(a, xs, cins, n_in, h, w_, cmid, cout, stride))
    return (int)cudaErrorInvalidValue;
  a.w1 = w1;
  a.scale1 = scale1;
  a.bias1 = bias1;
  a.w2 = w2;
  a.scale2 = scale2;
  a.bias2 = bias2;
  a.out = out;
  a.relu1 = relu1;
  a.relu2 = relu2;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return (int)launch_f32(a, n, s);
  return (int)launch_bf16(a, n, s);
}

// The launch vm_planar_conv2 makes for bf16 planes of these shapes:
// plan[0] tile edge (0: none fits), plan[1] blocks, plan[2] shared-memory
// bytes. Returns 0, or cudaErrorInvalidValue for shapes it refuses.
extern "C" int vm_planar_conv2_plan(const int* cins, int n_in, int n, int h,
                                    int w_, int cmid, int cout, int stride,
                                    int* plan) {
  const void* xs[kMaxIn] = {nullptr, nullptr, nullptr};
  Args a;
  if (!make_args(a, xs, cins, n_in, h, w_, cmid, cout, stride))
    return (int)cudaErrorInvalidValue;
  const mma::Plan p = plan_bf16(a, n);
  plan[0] = p.tile;
  plan[1] = p.blocks;
  plan[2] = (int)p.smem;
  return 0;
}
