// Modulated deformable 3x3 sampling (DCNv2 im2col) for NVIDIA Hopper, sm_90a.
//
// One source, three entry points, one per TPU kernel it replaces (all in
// deft_tpu/ops/pallas_dcn.py):
//
//   dcn_sample        _cm_kernel (via deform_conv_pallas_cm / the hybrid's
//                     C <= 128 branch) and the XLA deform_conv_onehot branch
//                     the hybrid takes for C > 128: both compute the same
//                     function, so this one entry serves every layer under
//                     dcn_impl="hybrid".  Float32 arithmetic on x as given.
//   dcn_sample_tap    _dcn_tap_kernel (via deform_sample_pallas /
//                     deform_conv_pallas_tap, dcn_impl="pallas"): the same
//                     sampling on x rounded to bfloat16 (the TPU kernel's
//                     slab, pallas_dcn.py:405), float32 blend, patches in x's
//                     dtype.
//   dcn_sample_onehot _onehot_kernel (via deform_conv_pallas_onehot): x
//                     rounded to bfloat16, the two horizontal bilinear
//                     weights rounded to bfloat16 (pallas_dcn.py:494), the
//                     vertical ones float32, float32 sums, bfloat16 patches
//                     (:548).
//
// Function: for output pixel p = (h, w) and tap k = (ky, kx) in {-1, 0, 1}^2,
//   patches[p, k*C + c] = mask[p, k] * bilinear(x, h + ky + dy, w + kx + dx)[c]
// with (dy, dx) = clip(offsets[p, k], -radius, radius) (no clip for a
// negative radius, dcn_sample only) and zero for every bilinear corner outside
// the image -- deft_tpu/models/dcn.py::deform_sample plus the clamp.
// Layouts: x [H, W, C] (float32 or bfloat16), offsets [H, W, 9, 2] float32
// (dy, dx), mask [H, W, 9] float32, patches [H*W, 9*C], tap-major rows ready
// for the [9C, Cout] weight product, which the caller runs as a library GEMM
// (the JAX package also leaves that product outside these kernels,
// pallas_dcn.py:452, :573, :726-728).
//
// What bounds it: bytes.  A patch row is 9x the size of its input pixel, so
// writing the patches dominates: per frame at 544x960 the 16 DCNv2 layers of
// DLA-34 write 171.6 M patch elements (0.686 GB in float32, half in
// bfloat16), at least 0.2 ms at the H100's 3.35 TB/s, and the GEMM reads them
// back once more.  The operations (8 per element) are far below the card's
// float32 rate.
//
// Design (a first, correct version):
//   * each block takes TILE_PIX output pixels; phase 1 computes, once per
//     (pixel, tap), the four corner indices and weights and keeps them in
//     shared memory;
//   * phase 2 strides the block's threads over (pixel, tap, channel) with the
//     channel fastest, so a warp reads neighbouring channels of each corner
//     and writes one contiguous stretch of the patch rows; channels move in
//     16-byte packs where C and the pointers allow it.
//   * There is no offset gate and no shift loop: the TPU kernels needed those
//     because a TPU cannot gather; the GPU gathers the four corners.
//   * The onehot entry repeats the TPU kernel's own weight arithmetic
//     (horizontal hat on the padded column grid, vertical hat per integer row
//     shift) so that its bfloat16 roundings fall where the TPU kernel's do.
// A later version fuses the sampling into the GEMM's shared-memory tiles so
// the patches never reach device memory (dcn_fused.cu does so with FFMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KK = 9;          // taps of the 3x3 kernel
constexpr int TILE_PIX = 32;   // output pixels per block
constexpr int THREADS = 256;

enum Mode { kPlain = 0, kTap = 1, kOnehot = 2 };

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

template <typename T, typename O, int V, int MODE>
__global__ void __launch_bounds__(THREADS)
dcn_sample_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                  const float* __restrict__ mask, O* __restrict__ out, int H,
                  int W, int C, int radius) {
  // per (pixel, tap): corner index (-1 outside the image, onehot only) and
  // weight; plain/tap fold the mask into the four weights, onehot keeps
  // (wx0, wx1, wy0, wy1) and the mask apart
  __shared__ int s_idx[TILE_PIX * KK][4];
  __shared__ float s_w[TILE_PIX * KK][4];
  __shared__ float s_m[TILE_PIX * KK];

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
    const float m = mask[(size_t)p * KK + k];
    if constexpr (MODE == kOnehot) {
      // vertical: hat(dy - u) for the integer row shifts u = floor(dy),
      // floor(dy) + 1 (pallas_dcn.py:498); horizontal: hat on the column
      // grid padded by radius + 2 (:492-494), rounded to bfloat16
      const int pad = radius + 2;
      const float fy = floorf(dy);
      const float pos = (float)(w + pad + k % 3 - 1) + dx;
      const float px = floorf(pos);
      s_w[e][0] = round_bf16(1.0f - (pos - px));
      s_w[e][1] = round_bf16(1.0f - ((px + 1.0f) - pos));
      s_w[e][2] = fmaxf(0.0f, 1.0f - fabsf(dy - fy));
      s_w[e][3] = fmaxf(0.0f, 1.0f - fabsf(dy - (fy + 1.0f)));
      s_m[e] = m;
      const int r0 = h + k / 3 - 1 + (int)fy;
      const int c0 = (int)px - pad;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + (j >> 1);
        const int c = c0 + (j & 1);
        s_idx[e][j] = (r >= 0 && r < H && c >= 0 && c < W) ? r * W + c : -1;
      }
    } else {
      // same float operations as deform_sample: (index + tap) + offset
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
        s_idx[e][j] = inb ? (int)yc * W + (int)xc : 0;
        s_w[e][j] = inb ? wgt[j] * m : 0.0f;
      }
    }
  }
  __syncthreads();

  // phase 2: gather-and-blend, channel fastest across the threads
  using P = Pack<T, V>;
  using PO = Pack<O, V>;
  const int cv = C / V;
  const P* __restrict__ xv = reinterpret_cast<const P*>(x);
  PO* __restrict__ ov = reinterpret_cast<PO*>(out) + (size_t)p0 * KK * cv;
  const int total = nent * cv;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int e = i / cv;
    const int c = i - e * cv;
    float acc[V];
    if constexpr (MODE == kOnehot) {
      // g_row = wx0 * x[row, c0] + wx1 * x[row, c0 + 1], then the vertical
      // weights and the mask, in the TPU kernel's order
      float g[2][V];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
#pragma unroll
        for (int t = 0; t < V; ++t) g[row][t] = 0.0f;
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const int idx = s_idx[e][2 * row + col];
          if (idx < 0) continue;
          const float wx = s_w[e][col];
          const P v = xv[(size_t)idx * cv + c];
#pragma unroll
          for (int t = 0; t < V; ++t)
            g[row][t] += wx * round_bf16(to_float(v.v[t]));
        }
      }
      const float wy0 = s_w[e][2], wy1 = s_w[e][3], m = s_m[e];
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = (g[0][t] * wy0 + g[1][t] * wy1) * m;
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wj = s_w[e][j];
        const P v = xv[(size_t)s_idx[e][j] * cv + c];
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const float f = to_float(v.v[t]);
          acc[t] += wj * (MODE == kTap ? round_bf16(f) : f);
        }
      }
    }
    PO o;
#pragma unroll
    for (int t = 0; t < V; ++t) from_float(acc[t], &o.v[t]);
    ov[i] = o;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename O, int V, int MODE>
void launch(const void* x, const float* offsets, const float* mask, void* out,
            int H, int W, int C, int radius, cudaStream_t stream) {
  const int blocks = (H * W + TILE_PIX - 1) / TILE_PIX;
  dcn_sample_kernel<T, O, V, MODE><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<O*>(out), H, W, C,
      radius);
}

// Picks 16-byte input packs where C and the pointers allow it.  The output
// is in x's dtype, except for kOnehot, whose output is always bfloat16.
template <int MODE>
int dispatch(const void* x, const void* offsets, const void* mask, void* out,
             int H, int W, int C, int radius, int dtype, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (MODE != kPlain && radius < 0) return (int)cudaErrorInvalidValue;
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (dtype == 0) {
    using O = typename std::conditional<MODE == kOnehot, BF, float>::type;
    if (C % 4 == 0 && aligned(x, 16) && aligned(out, 4 * sizeof(O))) {
      launch<float, O, 4, MODE>(x, off, msk, out, H, W, C, radius, s);
    } else {
      launch<float, O, 1, MODE>(x, off, msk, out, H, W, C, radius, s);
    }
  } else if (dtype == 1) {
    if (C % 8 == 0 && aligned(x, 16) && aligned(out, 16)) {
      launch<BF, BF, 8, MODE>(x, off, msk, out, H, W, C, radius, s);
    } else {
      launch<BF, BF, 1, MODE>(x, off, msk, out, H, W, C, radius, s);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x).  Each returns the cudaError_t of
// the launch (0 on success); the kernel runs on `stream` and does not
// synchronise.  dcn_sample_tap and dcn_sample_onehot need radius >= 0.
extern "C" int dcn_sample(const void* x, const void* offsets, const void* mask,
                          void* out, int H, int W, int C, int radius, int dtype,
                          void* stream) {
  return dispatch<kPlain>(x, offsets, mask, out, H, W, C, radius, dtype,
                          stream);
}

extern "C" int dcn_sample_tap(const void* x, const void* offsets,
                              const void* mask, void* out, int H, int W, int C,
                              int radius, int dtype, void* stream) {
  return dispatch<kTap>(x, offsets, mask, out, H, W, C, radius, dtype, stream);
}

extern "C" int dcn_sample_onehot(const void* x, const void* offsets,
                                 const void* mask, void* out, int H, int W,
                                 int C, int radius, int dtype, void* stream) {
  return dispatch<kOnehot>(x, offsets, mask, out, H, W, C, radius, dtype,
                           stream);
}
