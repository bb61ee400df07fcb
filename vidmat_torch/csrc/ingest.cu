// Fused frame ingest: uint8 NHWC -> s x s area pool -> per-channel
// x * scale + offset -> bf16 (or f32) NHWC.
//
// Replaces the TPU kernel vidmat/ops/pallas/ingest_kernel.py
// ingest_pool_normalize (_ingest_call / _ingest_kernel). The TPU kernel
// pools with two 0/1 matrices on the MXU; here one thread owns one output
// pixel and sums its s x s x C bytes as exact integers.
//
// Bound: bytes. At 1088x1920, pool 4: 6.3 MB of bytes read once, 0.8 MB of
// bf16 written; 2 integer adds per byte. Each thread reads s runs of s*C
// contiguous bytes, so a warp reads s runs of 32*s*C contiguous bytes.
//
// Arithmetic (matches the JAX kernel and the plain PyTorch version bit for
// bit): f32(sum) * (1/s^2), then * scale, then + offset, each rounded, then
// round-to-nearest-even to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Norm {
  float scale[4];
  float offset[4];
};

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename OutT, int C>
__global__ void ingest_kernel(const uint8_t* __restrict__ img,
                              OutT* __restrict__ out, int n, int h, int w,
                              int pool, float inv_area, Norm norm) {
  const int oh = h / pool, ow = w / pool;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (long long)n * oh * ow) return;
  const int ox = (int)(pix % ow);
  const long long t = pix / ow;
  const int oy = (int)(t % oh);
  const int b = (int)(t / oh);

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
  OutT* o = out + pix * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float v = __fmul_rn((float)acc[c], inv_area);
    v = __fadd_rn(__fmul_rn(v, norm.scale[c]), norm.offset[c]);
    store(o + c, v);
  }
}

template <typename OutT>
cudaError_t launch(const uint8_t* img, OutT* out, int n, int h, int w, int c,
                   int pool, Norm norm, cudaStream_t stream) {
  const long long total = (long long)n * (h / pool) * (w / pool);
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  const float inv_area = 1.0f / (float)(pool * pool);
  if (total == 0) return cudaSuccess;
  if (c == 3) {
    ingest_kernel<OutT, 3><<<blocks, threads, 0, stream>>>(
        img, out, n, h, w, pool, inv_area, norm);
  } else if (c == 4) {
    ingest_kernel<OutT, 4><<<blocks, threads, 0, stream>>>(
        img, out, n, h, w, pool, inv_area, norm);
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
