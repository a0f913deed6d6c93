// Fused modulated deformable 3x3 convolution (DCNv2 sampling + the [9C, Cout]
// weight product + bias in one kernel) for NVIDIA Hopper, sm_90a.
//
// Replaces deft_tpu/ops/pallas_dcn.py::_dcn_kernel (via deform_conv_pallas),
// which samples a row tile into VMEM and multiplies it by the weight inside
// the kernel body (pallas_dcn.py:263-267), so the patches never reach device
// memory.  Its function: x rounded to bfloat16 (the TPU kernel's slab,
// :297), the clamped bilinear sampling times the mask in float32, the float32
// product with the float32 weight, plus the bias, out in x's dtype.
//
// Layouts: x [H, W, C] (float32 or bfloat16), offsets [H, W, 9, 2] float32
// (dy, dx), mask [H, W, 9] float32, weight [9C, Cout] float32 tap-major, bias
// [Cout] float32, out [H*W, Cout] in x's dtype.
//
// What bounds it: operations.  It moves only x, the offsets, the mask, the
// weight and the output (no patches), but does 2 * H*W * 9C * Cout float32
// operations: 28.3 GFLOP per frame over the 16 DCNv2 layers of DLA-34 at
// 544x960, at least 0.42 ms at the H100's 67 TFLOP/s outside the tensor
// cores.
//
// Design (a first, correct version; plain FFMA, no tensor cores):
//   * each block owns BM output pixels x BN output channels; phase 1 computes
//     the four corner indices and mask-folded weights of every (pixel, tap)
//     of its pixels once into shared memory (the same float operations as
//     dcn_sample.cu, so sample positions match the references' bit for bit);
//   * it then walks the 9C reduction in BK-wide chunks: the block samples
//     its [BM, BK] slice of the patch matrix straight into shared memory
//     (channel fastest across a warp, so corner reads are coalesced), stages
//     the [BK, BN] weight slice beside it, and each thread accumulates a 4x4
//     register tile in float32;
//   * the bias is added and the result converted to x's dtype on the way out.
// The sampling is redone for each of a layer's Cout / BN column tiles.  A
// later version moves the product onto the tensor cores (mma.sync / wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KK = 9;         // taps of the 3x3 kernel
constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // reduction chunk
constexpr int TM = 4;         // register tile: pixels per thread
constexpr int TN = 4;         // register tile: channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fused_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                 const float* __restrict__ mask,
                 const float* __restrict__ weight,
                 const float* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int C, int Cout, int radius) {
  __shared__ int s_idx[BM * KK][4];
  __shared__ float s_w[BM * KK][4];
  __shared__ float As[BK][BM + 1];    // +1: conflict-free column writes
  __shared__ float Bs[BK][BN];

  const int hw = H * W;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int npix = min(BM, hw - p0);

  // phase 1: corner indices and mask-folded weights per (pixel, tap)
  for (int e = threadIdx.x; e < BM * KK; e += blockDim.x) {
    if (e >= npix * KK) {
      for (int j = 0; j < 4; ++j) {
        s_idx[e][j] = 0;
        s_w[e][j] = 0.0f;
      }
      continue;
    }
    const int p = p0 + e / KK;
    const int k = e % KK;
    const int h = p / W;
    const int w = p - h * W;
    const float r = (float)radius;
    const float dy = fminf(fmaxf(offsets[(size_t)p * (2 * KK) + 2 * k], -r), r);
    const float dx =
        fminf(fmaxf(offsets[(size_t)p * (2 * KK) + 2 * k + 1], -r), r);
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
      const bool inb = yc >= 0.0f && yc <= (float)(H - 1) && xc >= 0.0f &&
                       xc <= (float)(W - 1);
      s_idx[e][j] = inb ? (int)yc * W + (int)xc : 0;
      s_w[e][j] = inb ? wgt[j] * m : 0.0f;
    }
  }
  __syncthreads();

  const int K = KK * C;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // the block's [BM, BK] slice of the patch matrix, sampled in place
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int kk = i % BK;
      const int p = i / BK;
      const int k = k0 + kk;
      float v = 0.0f;
      if (p < npix && k < K) {
        const int tap = k / C;
        const int c = k - tap * C;
        const int e = p * KK + tap;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v += s_w[e][j] * round_bf16(to_float(x[(size_t)s_idx[e][j] * C + c]));
      }
      As[kk][p] = v;
    }
    // the [BK, BN] weight slice
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int n = i % BN;
      const int kk = i / BN;
      const int k = k0 + kk;
      const int col = n0 + n;
      Bs[kk][n] = (k < K && col < Cout) ? weight[(size_t)k * Cout + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + ty * TM + i;
    if (p >= hw) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < Cout) from_float(acc[i][j] + bias[n], &out[(size_t)p * Cout + n]);
    }
  }
}

template <typename T>
void launch(const void* x, const float* offsets, const float* mask,
            const float* weight, const float* bias, void* out, int H, int W,
            int C, int Cout, int radius, cudaStream_t stream) {
  const dim3 grid((H * W + BM - 1) / BM, (Cout + BN - 1) / BN);
  dcn_fused_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), offsets, mask, weight, bias,
      static_cast<T*>(out), H, W, C, Cout, radius);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  radius >= 0.  Returns
// the cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and does not synchronise.
extern "C" int dcn_fused(const void* x, const void* offsets, const void* mask,
                         const void* weight, const void* bias, void* out, int H,
                         int W, int C, int Cout, int radius, int dtype,
                         void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || radius < 0)
    return (int)cudaErrorInvalidValue;
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, off, msk, wt, b, out, H, W, C, Cout, radius, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, off, msk, wt, b, out, H, W, C, Cout, radius, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
