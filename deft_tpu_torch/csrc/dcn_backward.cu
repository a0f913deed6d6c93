// T5: the backward of the DCNv2 sampling (modulated deformable im2col).
//
// Replaces what the JAX package differentiates instead of a Pallas kernel:
// the jax.vjp of deft_tpu/ops/pallas_dcn.py::deform_conv_onehot (:167), which
// _hybrid_bwd (:773-787) and the autodiff of deform_conv_onehot_remat
// (:733-747) take under a training batch.  The forward is T1 (dcn_sample) on a
// float32 x or T4 (dcn_sample_onehot) on a bfloat16 x; both compute
//
//   patches[p, k*C + c] = mask[p,k] * sum_j wt_j(p,k) * x[corner_j(p,k), c]
//
// with corners floor(pos) and floor(pos) + 1 of the position pos = (h + ky +
// dy, w + kx + dx), offsets clamped to +-radius.  Given g = dL/dpatches
// [H*W, 9*C] this kernel writes
//
//   dx[corner, c]      += g * mask * wt_j            (float32 atomicAdd)
//   doffsets[p, k, 0]   = mask * sum_c g * d(bilinear)/d(dy)
//   doffsets[p, k, 1]   = mask * sum_c g * d(bilinear)/d(dx)
//   dmask[p, k]         = sum_c g * bilinear
//
// The derivative of the bilinear blend is DCNv2's (the reference's
// modulated_deformable_col2im_coord): corners floor(pos) and floor(pos) + 1,
// so at an integer position it is the one-sided difference v(pos + 1) -
// v(pos).  An offset past the clamp gets no gradient; a corner outside the
// image contributes nothing.
//
// Design: one warp per (pixel, tap) entry, its lanes over the channels; the
// three per-entry sums are reduced with warp shuffles.  Bound: the atomics
// into dx (4 per sampled element) and the read of g; the first version is a
// simple one, speed is later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KK = 9;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS)
dcn_backward_kernel(const TG* __restrict__ g, const TX* __restrict__ x,
                    const float* __restrict__ offsets,
                    const float* __restrict__ mask, float* __restrict__ dx,
                    float* __restrict__ doffsets, float* __restrict__ dmask,
                    int H, int W, int C, int radius) {
  const long long entries = (long long)H * W * KK;
  const long long e = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (e >= entries) return;
  const int k = (int)(e % KK);
  const int p = (int)(e / KK);
  const int h = p / W;
  const int w = p - h * W;

  float oy = offsets[2 * e];
  float ox = offsets[2 * e + 1];
  bool pass_y = true, pass_x = true;
  if (radius >= 0) {
    const float r = (float)radius;
    pass_y = oy >= -r && oy <= r;
    pass_x = ox >= -r && ox <= r;
    oy = fminf(fmaxf(oy, -r), r);
    ox = fminf(fmaxf(ox, -r), r);
  }
  const float m = mask[e];
  const float yy = (float)(h + k / 3 - 1) + oy;
  const float xx = (float)(w + k % 3 - 1) + ox;
  const float y0f = floorf(yy);
  const float x0f = floorf(xx);
  const float ly = yy - y0f, lx = xx - x0f;
  const float hy = 1.0f - ly, hx = 1.0f - lx;
  // bounds on the float position, before any conversion (a far position
  // never becomes an index)
  const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
  const bool vy1 = y0f + 1.0f >= 0.0f && y0f + 1.0f <= (float)(H - 1);
  const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
  const bool vx1 = x0f + 1.0f >= 0.0f && x0f + 1.0f <= (float)(W - 1);
  const int y0 = vy0 ? (int)y0f : 0, y1 = vy1 ? (int)y0f + 1 : 0;
  const int x0 = vx0 ? (int)x0f : 0, x1 = vx1 ? (int)x0f + 1 : 0;
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  const size_t i00 = ((size_t)y0 * W + x0) * C, i01 = ((size_t)y0 * W + x1) * C;
  const size_t i10 = ((size_t)y1 * W + x0) * C, i11 = ((size_t)y1 * W + x1) * C;
  const float w00 = hy * hx * m, w01 = hy * lx * m;
  const float w10 = ly * hx * m, w11 = ly * lx * m;

  const TG* grow = g + (size_t)e * C;   // [H*W, 9, C] row of entry e
  float s_val = 0.0f, s_dy = 0.0f, s_dx = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float gv = to_float(grow[c]);
    const float a = v00 ? to_float(x[i00 + c]) : 0.0f;
    const float b = v01 ? to_float(x[i01 + c]) : 0.0f;
    const float cc = v10 ? to_float(x[i10 + c]) : 0.0f;
    const float d = v11 ? to_float(x[i11 + c]) : 0.0f;
    s_val += gv * (hy * (hx * a + lx * b) + ly * (hx * cc + lx * d));
    s_dy += gv * (hx * (cc - a) + lx * (d - b));
    s_dx += gv * (hy * (b - a) + ly * (d - cc));
    if (v00) atomicAdd(dx + i00 + c, gv * w00);
    if (v01) atomicAdd(dx + i01 + c, gv * w01);
    if (v10) atomicAdd(dx + i10 + c, gv * w10);
    if (v11) atomicAdd(dx + i11 + c, gv * w11);
  }
  s_val = warp_sum(s_val);
  s_dy = warp_sum(s_dy);
  s_dx = warp_sum(s_dx);
  if (lane == 0) {
    dmask[e] = s_val;
    doffsets[2 * e] = pass_y ? m * s_dy : 0.0f;
    doffsets[2 * e + 1] = pass_x ? m * s_dx : 0.0f;
  }
}

template <typename TX, typename TG>
int launch(const void* g, const void* x, const void* offsets,
           const void* mask, void* dx, void* doffsets, void* dmask, int H,
           int W, int C, int radius, cudaStream_t stream) {
  const long long entries = (long long)H * W * KK;
  const long long blocks = (entries + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dcn_backward_kernel<TX, TG><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const TX*>(x),
      static_cast<const float*>(offsets), static_cast<const float*>(mask),
      static_cast<float*>(dx), static_cast<float*>(doffsets),
      static_cast<float*>(dmask), H, W, C, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype, g_dtype: 0 = float32, 1 = bfloat16.  dx [H, W, C] float32 must be
// zeroed by the caller (the kernel adds into it); doffsets [H, W, 9, 2] and
// dmask [H, W, 9] float32 are written.  A negative radius means no clamp.
// Returns the cudaError_t of the launch (0 on success); the kernel runs on
// `stream` and does not synchronise.
extern "C" int dcn_backward(const void* g, const void* x, const void* offsets,
                            const void* mask, void* dx, void* doffsets,
                            void* dmask, int H, int W, int C, int radius,
                            int x_dtype, int g_dtype, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (x_dtype == 0 && g_dtype == 0)
    return launch<float, float>(g, x, offsets, mask, dx, doffsets, dmask, H,
                                W, C, radius, s);
  if (x_dtype == 1 && g_dtype == 1)
    return launch<BF, BF>(g, x, offsets, mask, dx, doffsets, dmask, H, W, C,
                          radius, s);
  if (x_dtype == 0 && g_dtype == 1)
    return launch<float, BF>(g, x, offsets, mask, dx, doffsets, dmask, H, W,
                             C, radius, s);
  if (x_dtype == 1 && g_dtype == 0)
    return launch<BF, float>(g, x, offsets, mask, dx, doffsets, dmask, H, W,
                             C, radius, s);
  return (int)cudaErrorInvalidValue;
}
