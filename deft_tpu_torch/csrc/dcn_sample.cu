// Modulated deformable 3x3 sampling (DCNv2 im2col) for NVIDIA Hopper, sm_90a.
//
// One source, two entry points, one per TPU kernel it replaces (both in
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
// (T4, _onehot_kernel, has its own source, dcn_onehot.cu.)
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
// Design:
//   * the grid is (entry tile, channel slice).  An entry is one (pixel, tap)
//     row of the patches; a block takes 256 consecutive entries, 32 per
//     warp, and a slice of the channels, whose width the wrapper picks from
//     the layer's shape (ops/cuda_dcn.py::plan_sample) so that the small
//     spatial layers, whose entry tiles alone leave most SMs idle, still
//     fill the card.  Each slice redoes the ~40 flops of an entry's corner
//     arithmetic against 8 flops per channel;
//   * no block barrier: each lane computes the corner indices and weights
//     of one of its warp's 32 entries (dcn_common.cuh) into a warp-private
//     slot of shared memory, and after __syncwarp the warp's lanes stride
//     over (entry, channel pack) with the pack fastest, so a warp reads
//     neighbouring channels of each corner and writes contiguous stretches
//     of the patch rows (the whole stretch where one slice holds all C);
//     channels move in 16-byte packs where C and the pointers allow it;
//   * stores are streaming (st.global.cs, evict-first): the GEMM reads the
//     patches back at once, and T2 plus that GEMM measured no slower with
//     them than with plain stores (PERF.md keeps both times);
//   * the grid does not touch an element's arithmetic: the same corner
//     weights, the same bf16 round of each corner value (dcn_sample_tap) and
//     the same order of the four FMAs in every mode, so dcn_sample_tap(x)
//     equals dcn_sample(x rounded to bf16) bit for bit in float32.
//   * There is no offset gate and no shift loop: the TPU kernels needed those
//     because a TPU cannot gather; the GPU gathers the four corners.
// dcn_fused.cu fuses the same sampling into tensor-core GEMM tiles, so that
// its patches never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_common.cuh"

namespace {

using namespace dcn;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WARP_ENT = 32;                  // (pixel, tap) entries a warp
constexpr int TILE_ENT = WARPS * WARP_ENT;    // entries a block

enum Mode { kPlain = 0, kTap = 1 };

// *dst = v, evict-first (st.global.cs)
template <typename O, int V>
__device__ __forceinline__ void store(Pack<O, V>* dst, const Pack<O, V>& v) {
  constexpr int bytes = sizeof(Pack<O, V>);
  if constexpr (bytes == 16) {
    __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(&v));
  } else if constexpr (bytes == 8) {
    __stcs(reinterpret_cast<int2*>(dst), *reinterpret_cast<const int2*>(&v));
  } else if constexpr (bytes == 4) {
    __stcs(reinterpret_cast<int*>(dst), *reinterpret_cast<const int*>(&v));
  } else {
    static_assert(bytes == 2, "pack size");
    __stcs(reinterpret_cast<unsigned short*>(dst),
           *reinterpret_cast<const unsigned short*>(&v));
  }
}

// slice_packs: V-channel packs per channel slice (blockIdx.y)
template <typename T, typename O, int V, int MODE>
__global__ void __launch_bounds__(THREADS)
dcn_sample_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                  const float* __restrict__ mask, O* __restrict__ out, int H,
                  int W, int C, int radius, int slice_packs) {
  // per warp and entry: corner index and mask-folded weight
  __shared__ int s_idx[WARPS][WARP_ENT][4];
  __shared__ float s_w[WARPS][WARP_ENT][4];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nent = H * W * KK;
  const int e0 = blockIdx.x * TILE_ENT + warp * WARP_ENT;
  if (e0 >= nent) return;
  const int n_here = min(WARP_ENT, nent - e0);

  // phase 1: sample positions, one entry per lane
  if (lane < n_here) {
    const int p = (e0 + lane) / KK;
    const int k = e0 + lane - p * KK;
    bilinear_corners(offsets, mask, p, k, H, W, radius, s_idx[warp][lane],
                     s_w[warp][lane]);
  }
  __syncwarp();

  // phase 2: gather-and-blend, the channel pack fastest across the lanes
  using P = Pack<T, V>;
  using PO = Pack<O, V>;
  const int cv = C / V;
  const int q0 = blockIdx.y * slice_packs;
  const int qn = min(slice_packs, cv - q0);
  const P* __restrict__ xv = reinterpret_cast<const P*>(x) + q0;
  PO* __restrict__ ov = reinterpret_cast<PO*>(out) + (size_t)e0 * cv + q0;
  const int total = n_here * qn;
#pragma unroll 2
  for (int i = lane; i < total; i += 32) {
    const int e = i / qn;
    const int c = i - e * qn;
    const int* idx = s_idx[warp][e];
    const float* wt = s_w[warp][e];
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float wj = wt[j];
      const P v = xv[(size_t)idx[j] * cv + c];   // one 16-byte load
      float f[V];
      pack_to_float<MODE == kTap>(v, f);
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] += wj * f[t];
    }
    PO o;
#pragma unroll
    for (int t = 0; t < V; ++t) from_float(acc[t], &o.v[t]);
    store(ov + (size_t)e * cv + c, o);
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename O, int V, int MODE>
int launch(const void* x, const float* offsets, const float* mask, void* out,
           int H, int W, int C, int radius, int slice, cudaStream_t stream) {
  // a slice narrower than C must hold whole packs
  if (slice < C && slice % V != 0) return (int)cudaErrorInvalidValue;
  const int cv = C / V;
  const int slice_packs = slice < C ? slice / V : cv;
  const dim3 grid((H * W * KK + TILE_ENT - 1) / TILE_ENT,
                  (cv + slice_packs - 1) / slice_packs);
  dcn_sample_kernel<T, O, V, MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<O*>(out), H, W, C,
      radius, slice_packs);
  return (int)cudaGetLastError();
}

// Picks 16-byte input packs where C and the pointers allow it.  The output
// is in x's dtype.
template <int MODE>
int dispatch(const void* x, const void* offsets, const void* mask, void* out,
             int H, int W, int C, int radius, int dtype, int slice,
             void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || slice <= 0)
    return (int)cudaErrorInvalidValue;
  if (MODE == kTap && radius < 0) return (int)cudaErrorInvalidValue;
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (dtype == 0) {
    if (C % 4 == 0 && aligned(x, 16) && aligned(out, 16))
      return launch<float, float, 4, MODE>(x, off, msk, out, H, W, C, radius,
                                           slice, s);
    return launch<float, float, 1, MODE>(x, off, msk, out, H, W, C, radius,
                                         slice, s);
  }
  if (dtype == 1) {
    if (C % 8 == 0 && aligned(x, 16) && aligned(out, 16))
      return launch<BF, BF, 8, MODE>(x, off, msk, out, H, W, C, radius, slice,
                                     s);
    return launch<BF, BF, 1, MODE>(x, off, msk, out, H, W, C, radius, slice,
                                   s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x).  slice: channels per block along
// grid.y (ops/cuda_dcn.py::plan_sample; below C it must be a multiple of the
// 8 channels of a bf16 pack).  Each returns the cudaError_t of the launch (0
// on success); the kernel runs on `stream` and does not synchronise.
// dcn_sample_tap needs radius >= 0.
extern "C" int dcn_sample(const void* x, const void* offsets, const void* mask,
                          void* out, int H, int W, int C, int radius, int dtype,
                          int slice, void* stream) {
  return dispatch<kPlain>(x, offsets, mask, out, H, W, C, radius, dtype, slice,
                          stream);
}

extern "C" int dcn_sample_tap(const void* x, const void* offsets,
                              const void* mask, void* out, int H, int W, int C,
                              int radius, int dtype, int slice,
                              void* stream) {
  return dispatch<kTap>(x, offsets, mask, out, H, W, C, radius, dtype, slice,
                        stream);
}
