// Pieces shared by the DCNv2 kernels: dtype conversions, the 16-byte
// channel packs, the bilinear corner arithmetic of one (pixel, tap) and the
// shared-memory limit of a kernel.  dcn_sample.cu and dcn_fused.cu take
// their sample positions from bilinear_corners, so T1-T3 sample at the
// same positions with the same weights, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace dcn {

constexpr int KK = 9;   // taps of the 3x3 kernel

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
// round-to-nearest-even to bfloat16, as astype(bfloat16) does
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int V>
struct __align__(sizeof(T) * V) Pack {
  T v[V];
};

// A pack's values as float32, rounded to bfloat16 (nearest even) when
// `round`; float32 pairs round in one cvt.rn.bf16x2.f32, which gives each
// value the same bits as round_bf16 in half the conversions.
template <bool round, int V>
__device__ __forceinline__ void pack_to_float(const Pack<float, V>& in,
                                              float out[V]) {
  if constexpr (!round) {
#pragma unroll
    for (int t = 0; t < V; ++t) out[t] = in.v[t];
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int t = 0; t < V; t += 2) {
      const float2 f = __bfloat1622float2(
          __float22bfloat162_rn(make_float2(in.v[t], in.v[t + 1])));
      out[t] = f.x;
      out[t + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) out[t] = round_bf16(in.v[t]);
  }
}
// bfloat16 values are their own rounding
template <bool round, int V>
__device__ __forceinline__ void pack_to_float(const Pack<__nv_bfloat16, V>& in,
                                              float out[V]) {
#pragma unroll
  for (int t = 0; t < V; ++t) out[t] = __bfloat162float(in.v[t]);
}

// Corner indices into the [H*W] pixels and mask-folded bilinear weights of
// output pixel p, tap k: the same float operations as
// deft_tpu/models/dcn.py::deform_sample ((index + tap) + offset), with the
// offsets clamped to +-radius (none for a negative radius).  A corner
// outside the image gets index 0 and weight 0.
__device__ __forceinline__ void bilinear_corners(
    const float* __restrict__ offsets, const float* __restrict__ mask, int p,
    int k, int H, int W, int radius, int idx[4], float wt[4]) {
  const int h = p / W;
  const int w = p - h * W;
  float dy = offsets[(size_t)p * (2 * KK) + 2 * k];
  float dx = offsets[(size_t)p * (2 * KK) + 2 * k + 1];
  if (radius >= 0) {
    const float r = (float)radius;
    dy = fminf(fmaxf(dy, -r), r);
    dx = fminf(fmaxf(dx, -r), r);
  }
  const float m = mask[(size_t)p * KK + k];
  const float yy = (float)(h + k / 3 - 1) + dy;
  const float xx = (float)(w + k % 3 - 1) + dx;
  const float y0 = floorf(yy);
  const float x0 = floorf(xx);
  const float wy1 = yy - y0;
  const float wx1 = xx - x0;
  const float wy0 = 1.0f - wy1;
  const float wx0 = 1.0f - wx1;
  const float wgt[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float yc = y0 + (float)(j >> 1);
    const float xc = x0 + (float)(j & 1);
    // bounds are tested on the float position, before any conversion
    const bool inb = yc >= 0.0f && yc <= (float)(H - 1) && xc >= 0.0f &&
                     xc <= (float)(W - 1);
    idx[j] = inb ? (int)yc * W + (int)xc : 0;
    wt[j] = inb ? wgt[j] * m : 0.0f;
  }
}

constexpr int MAX_DEVICES = 64;   // devices whose kernel settings are cached

// Once per kernel and device: let a block of Kernel take all the dynamic
// shared memory the device offers, so that every launch, whatever its
// plan, runs under the same setting (concurrent launches with different
// plans do not race on it).
template <auto Kernel>
cudaError_t allow_all_shared_memory() {
  static std::atomic<bool> ready[MAX_DEVICES];   // zero: false
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && ready[device].load(std::memory_order_acquire))
    return cudaSuccess;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device < MAX_DEVICES)
    ready[device].store(true, std::memory_order_release);
  return err;
}

}  // namespace dcn
