// Fused frame ingest: uint8 NHWC -> s x s area pool -> per-channel
// x * scale + offset -> bf16 (or f32) NHWC.
//
// Replaces the TPU kernel vidmat/ops/pallas/ingest_kernel.py
// ingest_pool_normalize (_ingest_call / _ingest_kernel). The TPU kernel
// pools with two 0/1 matrices on the MXU; here the window sums are exact
// integer sums on the CUDA cores.
//
// Bound: bytes. At 1088x1920, pool 4, per frame: 6.3 MB of bytes read
// once, 0.8 MB of bf16 written (a 4-frame chunk: 25.1 and 3.1 MB).
//
// Main path (pool 4, 3 channels, w % 16 == 0, aligned pointers): a thread
// owns 4 consecutive output pixels of an output row, whose input is 48
// bytes (16 pixels) of each of 4 input rows, starting on a 16-byte
// boundary; a warp owns 32 such groups of one output row. The warp reads
// its 4 input runs (1536 bytes each) into shared memory with 16-byte
// cp.async, lane l taking vectors l, l + 32 and l + 64 so each instruction
// reads 512 contiguous bytes (a thread reading its own 48 bytes made each
// instruction touch twice the sectors it used); then each thread reads its
// own 3 vectors a row back. Each output pixel's 12 bytes of a row are 3
// words; its channel sums are dp4a byte dot products with 0/1 masks (9 a
// row), exact in integers. The 12 outputs leave as three 8-byte (bf16) or
// 16-byte (f32) stores. A 3-D grid (groups of 4 outputs, output rows,
// frames) gives each thread its pixel without division.
//
// Other shapes (pools 1, 2, 8, 4 channels, other widths): one thread per
// output pixel, summing its s x s x C bytes one by one; also a 3-D grid.
//
// Arithmetic (matches the JAX kernel and the plain PyTorch version bit for
// bit): f32(sum) * (1/s^2), then * scale, then + offset, each rounded, then
// round-to-nearest-even to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16-byte global-to-shared copy without a register round trip (cp.async,
// L2 only); wait_copies waits for this thread's copies.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Norm {
  float scale[4];
  float offset[4];
};

__device__ __forceinline__ float normalize(unsigned int sum, float inv_area,
                                           float scale, float offset) {
  const float v = __fmul_rn((float)sum, inv_area);
  return __fadd_rn(__fmul_rn(v, scale), offset);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// 12 consecutive outputs: three 16-byte f32 stores (16-byte aligned), or
// three 8-byte bf16 stores (8-byte aligned).
__device__ __forceinline__ void store12(float* p, const float v[12]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}
__device__ __forceinline__ void store12(__nv_bfloat16* p, const float v[12]) {
  uint2* q = reinterpret_cast<uint2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[4 * k], v[4 * k + 1]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(v[4 * k + 2], v[4 * k + 3]);
    q[k] = make_uint2(*reinterpret_cast<const unsigned int*>(&lo),
                      *reinterpret_cast<const unsigned int*>(&hi));
  }
}

constexpr int kVecX = 32;  // groups of 4 outputs a warp
constexpr int kVecY = 4;   // warps (output rows) a block

// Byte masks of channel c within word k (0-2) of a pixel run of 4 RGB
// pixels: bytes 0-11 hold r g b r | g b r g | b r g b.
__device__ __forceinline__ unsigned int rgb_mask(int k, int c) {
  // word k, channel c -> 0x01000001 (bytes 0, 3), 0x00010000 (byte 2) or
  // 0x00000100 (byte 1)
  const int sel = (c - k + 3) % 3;
  return sel == 0 ? 0x01000001u : sel == 1 ? 0x00000100u : 0x00010000u;
}

template <typename OutT>
__global__ void __launch_bounds__(kVecX* kVecY)
    ingest_kernel_pool4_rgb(const uint8_t* __restrict__ img,
                            OutT* __restrict__ out, int h, int w,
                            Norm norm) {
  // Per warp: its 4 input rows' runs of 32 x 48 bytes.
  __shared__ uint4 stage[kVecY][4][3 * kVecX];
  const int oh = h / 4, ow = w / 4;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int g0 = blockIdx.x * kVecX;  // the warp's first group
  const int oy = blockIdx.y * kVecY + wy;
  const int b = blockIdx.z;
  if (oy >= oh) return;  // the whole warp
  const int ng = min(kVecX, ow / 4 - g0);
  const uint4* src = reinterpret_cast<const uint4*>(
      img + (((long long)b * h + 4 * oy) * w + 16 * g0) * 3);
  const int row = w * 3 / 16;  // 16-byte vectors per input row
  // Coalesced: lane l copies vectors l, l + 32, l + 64 of each row's run.
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int j = lane + k * kVecX;
      if (j < 3 * ng) copy16(&stage[wy][r][j], src + r * row + j);
    }
  wait_copies();
  __syncwarp();
  if (lane >= ng) return;
  unsigned int acc[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) acc[i] = 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // 48-byte stride between lanes: no bank conflicts
    const uint4* v = &stage[wy][r][3 * lane];
    const uint4 v0 = v[0], v1 = v[1], v2 = v[2];
    const unsigned int wd[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                                 v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          acc[3 * j + c] = __dp4a(wd[3 * j + k], rgb_mask(k, c),
                                  acc[3 * j + c]);
  }
  float res[12];
#pragma unroll
  for (int i = 0; i < 12; ++i)
    res[i] = normalize(acc[i], 1.0f / 16.0f, norm.scale[i % 3],
                       norm.offset[i % 3]);
  store12(out + (((long long)b * oh + oy) * ow + 4 * (g0 + lane)) * 3, res);
}

template <typename OutT, int C>
__global__ void ingest_kernel(const uint8_t* __restrict__ img,
                              OutT* __restrict__ out, int h, int w,
                              int pool, float inv_area, Norm norm) {
  const int oh = h / pool, ow = w / pool;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= ow) return;
  unsigned int acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0u;
  const uint8_t* base =
      img + (((long long)b * h + (long long)oy * pool) * w +
             (long long)ox * pool) * C;
  for (int dy = 0; dy < pool; ++dy) {
    const uint8_t* row = base + (long long)dy * w * C;
    for (int dx = 0; dx < pool; ++dx) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += row[dx * C + c];
    }
  }
  OutT* o = out + (((long long)b * oh + oy) * ow + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    store(o + c, normalize(acc[c], inv_area, norm.scale[c], norm.offset[c]));
}

template <typename OutT>
cudaError_t launch(const uint8_t* img, OutT* out, int n, int h, int w, int c,
                   int pool, Norm norm, cudaStream_t stream) {
  const int oh = h / pool, ow = w / pool;
  if ((long long)n * oh * ow == 0) return cudaSuccess;
  if (n > 65535 || oh > 65535) return cudaErrorInvalidValue;
  const bool vec = pool == 4 && c == 3 && w % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) %
                           (sizeof(OutT) == 4 ? 16 : 8) == 0;
  if (vec) {
    const dim3 block(kVecX, kVecY);
    const dim3 grid((ow / 4 + kVecX - 1) / kVecX, (oh + kVecY - 1) / kVecY,
                    n);
    ingest_kernel_pool4_rgb<OutT><<<grid, block, 0, stream>>>(img, out, h,
                                                               w, norm);
    return cudaGetLastError();
  }
  const int threads = 128;
  const dim3 grid((ow + threads - 1) / threads, oh, n);
  const float inv_area = 1.0f / (float)(pool * pool);
  if (c == 3) {
    ingest_kernel<OutT, 3><<<grid, threads, 0, stream>>>(
        img, out, h, w, pool, inv_area, norm);
  } else if (c == 4) {
    ingest_kernel<OutT, 4><<<grid, threads, 0, stream>>>(
        img, out, h, w, pool, inv_area, norm);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// img: (n, h, w, c) uint8; out: (n, h/pool, w/pool, c) bf16 (out_f32 = 0)
// or f32 (out_f32 = 1); params: host array [scale[c], offset[c]].
extern "C" int vm_ingest_pool_normalize(const void* img, void* out, int n,
                                        int h, int w, int c, int pool,
                                        const float* params, int out_f32,
                                        void* stream) {
  if (c < 1 || c > 4 || pool < 1 || h % pool || w % pool)
    return (int)cudaErrorInvalidValue;
  Norm norm;
  for (int i = 0; i < 4; ++i) {
    norm.scale[i] = i < c ? params[i] : 0.0f;
    norm.offset[i] = i < c ? params[c + i] : 0.0f;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* src = (const uint8_t*)img;
  if (out_f32)
    return (int)launch(src, (float*)out, n, h, w, c, pool, norm, s);
  return (int)launch(src, (__nv_bfloat16*)out, n, h, w, c, pool, norm, s);
}
