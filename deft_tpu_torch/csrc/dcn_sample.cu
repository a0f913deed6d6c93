// Modulated deformable 3x3 sampling (DCNv2 im2col) for NVIDIA Hopper, sm_90a.
//
// Replaces deft_tpu/ops/pallas_dcn.py::_cm_kernel (reached through
// deform_conv_pallas_cm and deform_conv_hybrid for C <= 128 on a TPU) and the
// XLA deform_conv_onehot branch that deform_conv_hybrid takes for C > 128.
// Both compute the same function, so this one kernel serves every DCNv2 layer
// of the DLA-34 neck.
//
// Function: for output pixel p = (h, w) and tap k = (ky, kx) in {-1, 0, 1}^2,
//   patches[p, k*C + c] = mask[p, k] * bilinear(x, h + ky + dy, w + kx + dx)[c]
// with (dy, dx) = clip(offsets[p, k], -radius, radius) (no clip for a
// negative radius) and zero for every bilinear corner outside the image --
// deft_tpu/models/dcn.py::deform_sample plus the clamp of the hybrid path.
// Layouts: x [H, W, C] (float32 or bfloat16), offsets [H, W, 9, 2] float32
// (dy, dx), mask [H, W, 9] float32, patches [H*W, 9*C] in x's dtype, tap-major
// rows ready for the [9C, Cout] weight product, which the caller runs as a
// library GEMM (the JAX package also leaves that product outside its kernel,
// pallas_dcn.py:726-728).  Arithmetic is float32.
//
// What bounds it: bytes.  A patch row is 9x the size of its input pixel, so
// writing the patches dominates: per frame at 544x960 the 16 DCNv2 layers of
// DLA-34 write 171.6 M patch elements (0.686 GB in float32), at least 0.2 ms
// at the H100's 3.35 TB/s, and the GEMM reads them back once more.  The
// operations (8 per element) are far below the card's float32 rate.
//
// Design (a first, correct version):
//   * each block takes TILE_PIX output pixels; phase 1 computes, once per
//     (pixel, tap), the four corner indices and weights with the mask folded
//     in and out-of-image corners zeroed, and keeps them in shared memory;
//   * phase 2 strides the block's threads over (pixel, tap, channel) with the
//     channel fastest, so a warp reads neighbouring channels of each corner
//     and writes one contiguous stretch of the patch rows; channels move in
//     16-byte packs where C and the pointers allow it.
//   * There is no offset gate: the TPU kernel needed one to skip static
//     shifts because it cannot gather; the GPU gathers the four corners.
// A later version fuses the sampling into the GEMM's shared-memory tiles so
// the patches never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KK = 9;          // taps of the 3x3 kernel
constexpr int TILE_PIX = 32;   // output pixels per block
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

template <typename T, int V>
struct __align__(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
dcn_sample_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                  const float* __restrict__ mask, T* __restrict__ out, int H,
                  int W, int C, int radius) {
  __shared__ int s_idx[TILE_PIX * KK][4];
  __shared__ float s_w[TILE_PIX * KK][4];

  const int hw = H * W;
  const int p0 = blockIdx.x * TILE_PIX;
  const int npix = min(TILE_PIX, hw - p0);
  const int nent = npix * KK;

  // phase 1: sample positions, one (pixel, tap) per thread
  for (int e = threadIdx.x; e < nent; e += blockDim.x) {
    const int p = p0 + e / KK;
    const int k = e % KK;
    const int h = p / W;
    const int w = p - h * W;
    float dy = offsets[(size_t)p * (2 * KK) + 2 * k];
    float dx = offsets[(size_t)p * (2 * KK) + 2 * k + 1];
    if (radius >= 0) {
      const float r = (float)radius;
      dy = fminf(fmaxf(dy, -r), r);
      dx = fminf(fmaxf(dx, -r), r);
    }
    // same float operations as deform_sample: (index + tap) + offset
    const float yy = (float)(h + k / 3 - 1) + dy;
    const float xx = (float)(w + k % 3 - 1) + dx;
    const float y0 = floorf(yy);
    const float x0 = floorf(xx);
    const float wy1 = yy - y0;
    const float wx1 = xx - x0;
    const float wy0 = 1.0f - wy1;
    const float wx0 = 1.0f - wx1;
    const float m = mask[(size_t)p * KK + k];
    const float wgt[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float yc = y0 + (float)(j >> 1);
      const float xc = x0 + (float)(j & 1);
      // bounds are tested on the float position, before any conversion
      const bool inb = yc >= 0.0f && yc <= (float)(H - 1) && xc >= 0.0f &&
                       xc <= (float)(W - 1);
      s_idx[e][j] = inb ? (int)yc * W + (int)xc : 0;
      s_w[e][j] = inb ? wgt[j] * m : 0.0f;
    }
  }
  __syncthreads();

  // phase 2: gather-and-blend, channel fastest across the threads
  using P = Pack<T, V>;
  const int cv = C / V;
  const P* __restrict__ xv = reinterpret_cast<const P*>(x);
  P* __restrict__ ov = reinterpret_cast<P*>(out) + (size_t)p0 * KK * cv;
  const int total = nent * cv;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int e = i / cv;
    const int c = i - e * cv;
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float wj = s_w[e][j];
      const P v = xv[(size_t)s_idx[e][j] * cv + c];
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] += wj * to_float(v.v[t]);
    }
    P o;
#pragma unroll
    for (int t = 0; t < V; ++t) from_float(acc[t], &o.v[t]);
    ov[i] = o;
  }
}

template <typename T, int V>
void launch(const void* x, const float* offsets, const float* mask, void* out,
            int H, int W, int C, int radius, cudaStream_t stream) {
  const int blocks = (H * W + TILE_PIX - 1) / TILE_PIX;
  dcn_sample_kernel<T, V><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<T*>(out), H, W, C,
      radius);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); the kernel runs on `stream` and does not synchronise.
extern "C" int dcn_sample(const void* x, const void* offsets, const void* mask,
                          void* out, int H, int W, int C, int radius, int dtype,
                          void* stream) {
  if (H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (C % 4 == 0 && aligned(x, 16) && aligned(out, 16)) {
      launch<float, 4>(x, off, msk, out, H, W, C, radius, s);
    } else {
      launch<float, 1>(x, off, msk, out, H, W, C, radius, s);
    }
  } else if (dtype == 1) {
    if (C % 8 == 0 && aligned(x, 16) && aligned(out, 16)) {
      launch<__nv_bfloat16, 8>(x, off, msk, out, H, W, C, radius, s);
    } else {
      launch<__nv_bfloat16, 1>(x, off, msk, out, H, W, C, radius, s);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
