// Multi-input conv + folded-BN affine + activation:
//   out = act(conv_k,stride(concat(xs), w) * scale + bias), cast to T
// k in {1, 3} (zero padding k/2), stride in {1, 2}, up to 3 inputs whose
// concatenation never materializes.
//
// Replaces the TPU kernel vidmat/ops/pallas/planar.py planar_conv
// (_conv_kernel). There each lane chunk of a flattened pitched plane is a
// sum of per-tap MXU matmuls, a stride-2 conv is a 4-tap conv on an
// s2d-repacked plane, and an interior-mask multiply re-zeroes the pad
// ring. Here the stride-2 conv is computed directly, and zero padding
// stands for the pad ring.
//
// bf16 planes (the serving path) run on the tensor cores
// (planar_mma.cuh): a block owns a th x tw output tile of one image and a
// slice of nb output channels. It copies its slice of the weights, packed
// once in the staged [n][tap][k] layout (ops/planar.py pack_conv_weight),
// in 16-byte vectors, stages the input region ((th-1)*s + k rows) channels
// last, reading each channel's image rows in 16-byte vectors of 8 pixels
// where the planes are 16-byte aligned, and runs one implicit-GEMM stage
// (1 or 9 taps) whose epilogue writes the tile. Values near a bf16
// rounding midpoint are recomputed in the CUDA-core order, so each bf16
// value is the one the f32 kernel's order gives (planar_mma.cuh,
// Numerics). The tile and the slice come from a cost estimate
// (plan_bf16): at the bottleneck's 9x15 grid the output channels are
// split so that tens of blocks share the work.
//
// f32 planes are the parity instantiation: a block stages the input region
// of a t x t output tile for all input channels channel-major, zero outside
// the image, and each thread sums 9 (or 1) taps x C_in for CG output
// channels of one pixel in f32 registers (exact products, the 1e-5 bar).
//
// Main-path sites (1080p, s2d 2, per 4-frame chunk): the stem 12 -> 16,
// stride 2, 144x240 -> 72x120 (60 M multiply-adds, 4.4 MB of bf16), and
// the bottleneck 1x1 64 -> 64 at 9x15 (2.2 M multiply-adds). Bytes bound
// both on this card; what the kernel spends goes to device-memory latency
// (staging) and the K loop, one block's serial work.

#include "planar_mma.cuh"

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

cudaError_t launch_f32(Args a, int k, int n, cudaStream_t stream) {
  auto smem_of = [&](int t) {
    const int r = (t - 1) * a.stride + k;
    return (size_t)a.in.total * r * r * sizeof(float);
  };
  a.tile = pick_tile(n, a.oh, a.ow, smem_of);
  if (!grid_ok(n, a.oh, a.ow, a.tile)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(a.tile);
  const void* fn = k == 3 ? (const void*)planar_conv_kernel<float, 3>
                          : (const void*)planar_conv_kernel<float, 1>;
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ow + a.tile - 1) / a.tile, (a.oh + a.tile - 1) / a.tile,
                  n);
  if (k == 3)
    planar_conv_kernel<float, 3><<<grid, kThreads, smem, stream>>>(a);
  else
    planar_conv_kernel<float, 1><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- bf16 planes: tensor cores ----

using mma::bf16;

// The launch of the bf16 kernel: output tile th x tw, nb output channels
// per block (a multiple of 8), blocks, shared memory.
struct Plan {
  int th, tw, nb, blocks;
  size_t smem;
};

// Shared memory of the bf16 kernel, in bf16 elements from the start: the
// input region [rows * cols][ps], the weight slice [up(nb, 8)][taps * kp
// + 8], the warps' recompute queues.
struct Layout {
  int rows, cols, kp, ps, taps;
  size_t w, queue, total;

  __host__ __device__ Layout(int cin, int k, int stride, int th, int tw,
                             int nb) {
    rows = (th - 1) * stride + k;
    cols = (tw - 1) * stride + k;
    kp = mma::up(cin, 16);
    ps = mma::pstride(cin);
    taps = k * k;
    w = (size_t)rows * cols * ps;
    queue = w + mma::welems(nb, kp, taps);
    total = queue + mma::kQueueBytes / sizeof(bf16);
  }
};

struct MArgs {
  Planes in;
  const bf16* wp;  // (up(cout, 8), taps * kp + 8), pack_conv_weight
  const float* scale;
  const float* bias;
  bf16* out;
  int h, w_, oh, ow, cout, stride, relu, th, tw, nb, vec;
};

// Fills channels [0, in.total) of every pixel of the rows x cols region
// whose top-left pixel is (y0, x0) of image b (zero outside the image) in
// dst, pixel stride ps. One item is 8 pixels of one channel of one region
// row, aligned to 8 image columns: one 16-byte load where `vec` (every
// plane and image row 16-byte aligned), else 8 loads. Channels are the
// fastest index, so a warp's 2-byte stores land on neighbouring channels
// of the same pixels; each thread keeps kU items' loads in flight.
__device__ void stage_rows(const Planes& in, int b, int hh, int ww, int y0,
                           int x0, int rows, int cols, bf16* dst, int ps,
                           int vec) {
  constexpr int kU = 4;
  const int c = in.total, hw = hh * ww;
  const int xa = x0 >= 0 ? x0 / 8 * 8 : -((7 - x0) / 8) * 8;
  const int nseg = (x0 + cols - xa + 7) / 8;
  const int total = rows * nseg * c;
  for (int base = threadIdx.x; base < total; base += kThreads * kU) {
    uint4 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads;
      q[u] = make_uint4(0, 0, 0, 0);
      if (i >= total) continue;
      const int ch = i % c, rs = i / c;
      const int r = rs / nseg, gx0 = xa + 8 * (rs - r * nseg);
      const int gy = y0 + r;
      if (gy < 0 || gy >= hh) continue;
      const bf16* src = mma::plane(in, b, ch, hw) + (long long)gy * ww;
      if (vec && gx0 >= 0 && gx0 + 8 <= ww) {
        q[u] = __ldg(reinterpret_cast<const uint4*>(src + gx0));
      } else {
        bf16* e = reinterpret_cast<bf16*>(&q[u]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gx0 + j >= 0 && gx0 + j < ww) e[j] = src[gx0 + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads;
      if (i >= total) continue;
      const int ch = i % c, rs = i / c;
      const int r = rs / nseg, lx0 = xa + 8 * (rs - r * nseg) - x0;
      const bf16* e = reinterpret_cast<const bf16*>(&q[u]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (lx0 + j >= 0 && lx0 + j < cols)
          dst[((size_t)r * cols + lx0 + j) * ps + ch] = e[j];
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
    planar_conv_kernel_mma(MArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = (bf16*)smem_raw;
  const int s = a.stride;
  const int slices = (a.cout + a.nb - 1) / a.nb;
  const int b = blockIdx.z / slices, n0 = (blockIdx.z - b * slices) * a.nb;
  const int nout = min(a.nb, a.cout - n0);
  const int oy0 = blockIdx.y * a.th, ox0 = blockIdx.x * a.tw;
  const Layout L(a.in.total, KS, s, a.th, a.tw, a.nb);
  bf16* region = sm;
  bf16* w = sm + L.w;
  unsigned* queue = (unsigned*)(sm + L.queue);

  // The weight slice: rows [n0, n0 + up(nout, 8)) of the packed tensor, a
  // contiguous run of 16-byte vectors (its rows are 8-element multiples).
  {
    const int nv = (int)(mma::welems(nout, L.kp, L.taps) / 8);
    const uint4* src = reinterpret_cast<const uint4*>(
        a.wp + (size_t)n0 * mma::wstride(L.kp, L.taps));
    uint4* dst = reinterpret_cast<uint4*>(w);
    for (int i = threadIdx.x; i < nv; i += kThreads) dst[i] = __ldg(src + i);
  }
  stage_rows(a.in, b, a.h, a.w_, oy0 * s - KS / 2, ox0 * s - KS / 2, L.rows,
             L.cols, region, L.ps, a.vec);
  mma::zero_cl(region, L.rows * L.cols, L.ps, a.in.total, L.kp);
  __syncthreads();

  const mma::Seg segs[1] = {
      {region, L.cols, L.ps, 0, L.kp / 16, 0, a.in.total}};
  bf16* out = a.out + ((long long)b * a.cout + n0) * a.oh * a.ow;
  const int tw = a.tw;
  auto put = [&](int m, int n, float v) {
    const int ly = m / tw, lx = m - ly * tw;
    out[((long long)n * a.oh + oy0 + ly) * a.ow + ox0 + lx] =
        __float2bfloat16_rn(v);
  };
  mma::conv_stage<KS>(
      segs, s, a.th, tw, w, L.kp, nout, queue,
      [&](int m, int n, float acc, float e) {
        const int ly = m / tw, lx = m - ly * tw;
        if (n >= nout || oy0 + ly >= a.oh || ox0 + lx >= a.ow) return true;
        float v;
        if (!mma::affine_checked(acc, e, a.scale[n0 + n], a.bias[n0 + n],
                                 a.relu, &v))
          return false;
        put(m, n, v);
        return true;
      },
      [&](int m, int n) {
        put(m, n,
            affine(mma::seq_sum<KS>(segs, s, tw, m, w, L.kp, n),
                   a.scale[n0 + n], a.bias[n0 + n], a.relu));
      });
}

// The tile and channel slice of least estimated time whose shared memory
// fits: waves of blocks (132 SMs, up to two blocks each: the kernel is
// bounded to 128 registers a thread) times one block's critical path
// (staging, the K loop, and a fixed latency per block: a device-memory
// round trip, ~30 K steps). A small tile recomputes no halo here but
// stages more region per output at stride 2; a thin channel slice
// re-stages the region once per slice. tile 0 if none fits.
Plan plan_bf16(int n, int cin, int cout, int oh, int ow, int k, int stride) {
  constexpr double kBlockLatency = 30.0;
  const int tiles[6][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 16}, {4, 8},
                           {4, 4}};
  Plan best{0, 0, 0, 0, 0};
  double best_cost = 0.0;
  for (int nb = mma::up(cout, 8);; nb = mma::up(nb / 2, 8)) {
    for (int i = 0; i < 6; ++i) {
      const int th = tiles[i][0], tw = tiles[i][1];
      const Layout L(cin, k, stride, th, tw, nb);
      const size_t smem = L.total * sizeof(bf16);
      if (smem > kMaxSmem) continue;
      const long long blocks = (long long)n * ((oh + th - 1) / th) *
                               ((ow + tw - 1) / tw) * ((cout + nb - 1) / nb);
      const int per_sm = smem * 2 + 2048 <= kMaxSmem ? 2 : 1;
      const long long waves = (blocks + 132 * per_sm - 1) / (132 * per_sm);
      const double work =
          kBlockLatency +
          mma::staging_work((double)L.rows * L.cols * L.kp +
                            (double)nb * (L.taps * L.kp + 8)) +
          mma::stage_work(th * tw, nb, L.kp, L.taps);
      const double cost = (double)waves * work;
      if (best.th == 0 || cost < best_cost) {
        best = Plan{th, tw, nb, (int)blocks, smem};
        best_cost = cost;
      }
    }
    if (nb == 8) break;
  }
  return best;
}

cudaError_t launch_bf16(const Args& a, const void* wp, int k, int n,
                        cudaStream_t stream) {
  const Plan p = plan_bf16(n, a.in.total, a.cout, a.oh, a.ow, k, a.stride);
  const int slices = p.th ? (a.cout + p.nb - 1) / p.nb : 0;
  if (p.th == 0 || (long long)n * slices > 65535 ||
      (a.oh + p.th - 1) / p.th > 65535)
    return cudaErrorInvalidValue;
  MArgs m;
  m.in = a.in;
  m.wp = (const bf16*)wp;
  m.scale = a.scale;
  m.bias = a.bias;
  m.out = (bf16*)a.out;
  m.h = a.h;
  m.w_ = a.w_;
  m.oh = a.oh;
  m.ow = a.ow;
  m.cout = a.cout;
  m.stride = a.stride;
  m.relu = a.relu;
  m.th = p.th;
  m.tw = p.tw;
  m.nb = p.nb;
  m.vec = a.w_ % 8 == 0;
  for (int i = 0; i < a.in.n; ++i)
    if (reinterpret_cast<uintptr_t>(a.in.p[i]) & 15) m.vec = 0;
  const void* fn = k == 3 ? (const void*)planar_conv_kernel_mma<3>
                          : (const void*)planar_conv_kernel_mma<1>;
  cudaError_t err = set_smem(fn, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.ow + p.tw - 1) / p.tw, (a.oh + p.th - 1) / p.th,
                  n * slices);
  if (k == 3)
    planar_conv_kernel_mma<3><<<grid, kThreads, p.smem, stream>>>(m);
  else
    planar_conv_kernel_mma<1><<<grid, kThreads, p.smem, stream>>>(m);
  return cudaGetLastError();
}

bool make_args(Args& a, const void* const* xs, const int* cins, int n_in,
               int h, int w_, int cout, int k, int stride) {
  if (n_in < 1 || n_in > kMaxIn || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || cout < 1 || h < 1 || w_ < 1)
    return false;
  a = Args{};
  a.in = make_planes(xs, cins, n_in);
  a.h = h;
  a.w_ = w_;
  a.oh = (h + 2 * (k / 2) - k) / stride + 1;
  a.ow = (w_ + 2 * (k / 2) - k) / stride + 1;
  a.cout = cout;
  a.stride = stride;
  return true;
}

}  // namespace

// xs: n_in pointers to (n, cins[i], h, w); w: (cout, sum cins, k, k);
// scale, bias: (cout,) f32; out: (n, cout, oh, ow) with
// oh = (h + 2*(k/2) - k)/stride + 1. Planes are bf16 (f32 = 0) or f32.
// bf16 planes read the weights from wp, w packed by pack_conv_weight
// ((up(cout, 8), k*k*up(sum cins, 16) + 8), 16-byte aligned); f32 planes
// from w.
extern "C" int vm_planar_conv(const void* const* xs, const int* cins,
                              int n_in, const void* w, const void* wp,
                              const float* scale, const float* bias,
                              void* out, int n, int h, int w_, int cout,
                              int k, int stride, int relu, int f32,
                              void* stream) {
  Args a;
  if (!make_args(a, xs, cins, n_in, h, w_, cout, k, stride))
    return (int)cudaErrorInvalidValue;
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.relu = relu;
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return (int)launch_f32(a, k, n, s);
  if (reinterpret_cast<uintptr_t>(wp) & 15) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(a, wp, k, n, s);
}

// The launch vm_planar_conv makes for bf16 planes of these shapes:
// plan[0], plan[1] the output tile's rows and columns (0: none fits),
// plan[2] output channels per block, plan[3] blocks, plan[4] shared-memory
// bytes. Returns 0, or cudaErrorInvalidValue for shapes it refuses.
extern "C" int vm_planar_conv_plan(const int* cins, int n_in, int n, int h,
                                   int w_, int cout, int k, int stride,
                                   int* plan) {
  const void* xs[kMaxIn] = {nullptr, nullptr, nullptr};
  Args a;
  if (!make_args(a, xs, cins, n_in, h, w_, cout, k, stride))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_bf16(n, a.in.total, cout, a.oh, a.ow, k, stride);
  plan[0] = p.th;
  plan[1] = p.tw;
  plan[2] = p.nb;
  plan[3] = p.blocks;
  plan[4] = (int)p.smem;
  return 0;
}
