// T4: modulated deformable 3x3 sampling as the TPU's one-hot kernel computes
// it, for NVIDIA Hopper, sm_90a.
//
// Replaces _onehot_kernel (deft_tpu/ops/pallas_dcn.py:463, via
// deform_conv_pallas_onehot :511, pallas_call :543).  Its plain version is
// ops/cuda_dcn.py::deform_sample_onehot_reference.  Function: for output
// pixel p = (h, w) and tap k = (ky, kx) in {-1, 0, 1}^2, with
// (dy, dx) = clip(offsets[p, k], -r, r), fy = floor(dy),
// pos = (w + r + 2 + kx) + dx on the column grid padded by r + 2 and
// px = floor(pos):
//   wx0, wx1 = bf16(1 - (pos - px)), bf16(1 - ((px + 1) - pos))   (:492-494)
//   wy0, wy1 = max(0, 1 - |dy - fy|), max(0, 1 - |dy - (fy + 1)|)  (:498)
//   g_i = wx0 * xb[h + ky + fy + i, px - r - 2]
//       + wx1 * xb[h + ky + fy + i, px - r - 1]                     (:500-505)
//   patches[p, k*C + c] = bf16((g_0 * wy0 + g_1 * wy1) * mask[p, k])
// where xb is x rounded to bfloat16 and zero outside the image (the TPU
// kernel's zero-padded bf16 slab, :538-539).  Layouts: x [H, W, C] float32 or
// bfloat16, offsets [H, W, 9, 2] float32 (dy, dx), mask [H, W, 9] float32,
// patches [H*W, 9*C] bfloat16, tap-major rows for the [9C, Cout] product
// that the caller runs outside (:573).
//
// What bounds it: bytes.  Per 544x960 frame the 16 DCNv2 layers of DLA-34
// write 343 MB of bf16 patches and read 76 MB of float32 x and 24 MB of
// offsets and mask: 0.132 ms at 3.35 TB/s.  The blend is 7 float32
// operations per output element, far below the card's rate, but its
// instructions (4 corner reads, unpacking, blend, pack, store) are close to
// the issue rate of the SMs at that byte rate, so the design keeps them few.
//
// Design (the TPU kernel's slab, cut to a tile):
//   * a block takes a tile of TH x TW pixels and a slice of Cs = 8P channels
//     (ops/cuda_dcn.py::plan_onehot picks both per layer and radius);
//   * fill: it first stages the window that the tile's samples can reach,
//     rows h0 - r - 1 .. h0 + TH + r + 1 and the same span of columns, as
//     bf16 in shared memory, zeros outside the image.  x crosses device
//     memory into the SM about once per tile (16-byte ld.global.nc, several
//     in flight per thread) and is rounded to bf16 once, as it is written;
//   * the offsets are clamped to +-r before any index is formed, so no
//     corner leaves the window: the blend has no bounds test and no branch;
//   * TPP = 3 threads per pixel: a warp takes 9 / TPP chunks of 32 (pixel,
//     tap) entries (2 threads per pixel, 5 chunks, measured slower at every
//     DLA-34 layer on an H100).  Each lane loads the offsets and mask of its
//     entries before the fill, so that their latency hides behind it and no
//     chunk waits on device memory;
//   * sample: per chunk, each lane computes one entry's hats, mask and
//     window position into a warp-private slot; after __syncwarp the warp's
//     lanes stride over (entry, 8-channel pack), the pack fastest, so one
//     corner is one 16-byte shared-memory read and neighbouring lanes read
//     neighbouring packs;
//   * the output leaves as 16-byte bf16 packs with streaming stores
//     (st.global.cs): the consumer GEMM reads the patches back at once.
// No tensor cores: the product stays outside, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_common.cuh"

namespace {

using namespace dcn;
using BF = __nv_bfloat16;

constexpr int PACK = 8;               // bf16 channels of one 16-byte pack
constexpr int TPP = 3;                // threads per pixel of a tile
constexpr int MAX_THREADS = 256 * TPP;
constexpr int FILL_BATCH = 4;         // window packs in flight per thread
constexpr int CHUNKS = (KK + TPP - 1) / TPP;  // chunks of 32 entries a warp

// One (pixel, tap) entry, written by one lane for its warp.
struct __align__(16) Entry {
  float wx0, wx1, wy0, wy1;   // horizontal hats (bf16-rounded), vertical hats
  float m;                    // mask
  int corner;                 // window pack of the top-left corner, pack 0
  int out;                    // element offset of the patch row; -1: no pixel
                              // (int: the entry takes < 2^31 outputs)
  int unused;
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 channels of x at `src` (n of them inside C) as one bf16 pack, zeros
// past C; VEC: all 8 there and 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ uint4 fetch(const float* __restrict__ src, int n) {
  float f[PACK];
  if constexpr (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int t = 0; t < PACK; ++t) f[t] = t < n ? __ldg(src + t) : 0.0f;
  }
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                    bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
}

template <bool VEC>
__device__ __forceinline__ uint4 fetch(const BF* __restrict__ src, int n) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    uint16_t u[PACK];
#pragma unroll
    for (int t = 0; t < PACK; ++t)
      u[t] = t < n ? __ldg(reinterpret_cast<const unsigned short*>(src) + t)
                   : (uint16_t)0;
    return make_uint4(u[0] | (uint32_t)u[1] << 16, u[2] | (uint32_t)u[3] << 16,
                      u[4] | (uint32_t)u[5] << 16, u[6] | (uint32_t)u[7] << 16);
  }
}

// bf16 pack -> float32, channel order
__device__ __forceinline__ void unpack(const uint4& v, float f[PACK]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// grid: (tile, channel slice); block: TPP * tile_h * tile_w threads,
// tile_h * tile_w a multiple of 32, tile_w = 1 << tw_log2; dynamic shared
// memory: the window, then 32 entries per warp.
template <typename T, int P, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
dcn_onehot_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                  const float* __restrict__ mask, BF* __restrict__ out, int H,
                  int W, int C, int radius, int tile_h, int tw_log2,
                  int tiles_w) {
  const int tile_w = 1 << tw_log2;
  extern __shared__ uint4 smem[];
  const int ww = tile_w + 2 * radius + 3;     // window columns
  const int wh = tile_h + 2 * radius + 3;     // window rows
  const int n_packs = wh * ww * P;
  uint4* win = smem;                          // [wh][ww][P] bf16 packs
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  Entry* slots = reinterpret_cast<Entry*>(smem + n_packs) + warp * 32;

  const int ty = blockIdx.x / tiles_w;
  const int h0 = ty * tile_h;
  const int w0 = (blockIdx.x - ty * tiles_w) * tile_w;
  const int cs0 = blockIdx.y * (P * PACK);

  // fill: window pack i = (row * ww + col) * P + q.  The row of a cell is
  // (cell + 0.5) * (1 / ww) in float32, without an integer division: the
  // quotient lies at least 0.5 / ww from an integer, far more than the
  // rounding error for every window a block can hold
  // (tests/test_torch_port_onehot.py checks each).
  auto fill = [&]() {
    const int row0 = h0 - radius - 1;
    const int col0 = w0 - radius - 1;
    const float inv_ww = 1.0f / (float)ww;
    for (int i0 = threadIdx.x; i0 < n_packs; i0 += FILL_BATCH * blockDim.x) {
      uint4 v[FILL_BATCH];
#pragma unroll
      for (int b = 0; b < FILL_BATCH; ++b) {
        const int i = i0 + b * blockDim.x;
        const int cell = i / P;
        const int wr = (int)(((float)cell + 0.5f) * inv_ww);
        const int gr = row0 + wr;
        const int gc = col0 + cell - wr * ww;
        const int ch = cs0 + (i % P) * PACK;
        v[b] = make_uint4(0, 0, 0, 0);
        if (i < n_packs && gr >= 0 && gr < H && gc >= 0 && gc < W && ch < C)
          v[b] = fetch<VEC>(x + ((size_t)gr * W + gc) * C + ch, C - ch);
      }
#pragma unroll
      for (int b = 0; b < FILL_BATCH; ++b) {
        const int i = i0 + b * blockDim.x;
        if (i < n_packs) win[i] = v[b];
      }
    }
  };

  // entry e of the tile: tap k = e % 9 of pixel e / 9 (row ly of the tile,
  // image column w, image pixel p); false where it lies outside the image
  auto locate = [&](int e, int& k, int& ly, int& w, int& p) {
    const int pix = e / KK;
    k = e - pix * KK;
    ly = pix >> tw_log2;
    const int h = h0 + ly;
    w = w0 + pix - (ly << tw_log2);
    p = h * W + w;
    return h < H && w < W;
  };

  // the raw offsets and mask of the lane's entry in each of its warp's
  // chunks (chunk warp + j * warps)
  const int chunks = tile_h * tile_w * KK / 32;
  float raw_dy[CHUNKS], raw_dx[CHUNKS], raw_m[CHUNKS];
  auto prefetch = [&]() {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      int k, ly, w, p;
      raw_dy[j] = raw_dx[j] = raw_m[j] = 0.0f;
      if (warp + j * warps < chunks &&
          locate((warp + j * warps) * 32 + lane, k, ly, w, p)) {
        raw_dy[j] = offsets[(size_t)p * (2 * KK) + 2 * k];
        raw_dx[j] = offsets[(size_t)p * (2 * KK) + 2 * k + 1];
        raw_m[j] = mask[(size_t)p * KK + k];
      }
    }
  };

  // the lane's entry of chunk j: the TPU kernel's weight arithmetic, then
  // window coordinates
  auto entry = [&](int j) {
    Entry en;
    int k, ly, w, p;
    en.out = -1;
    if (locate((warp + j * warps) * 32 + lane, k, ly, w, p)) {
      const float r = (float)radius;
      const float dy = fminf(fmaxf(raw_dy[j], -r), r);
      const float dx = fminf(fmaxf(raw_dx[j], -r), r);
      const int pad = radius + 2;
      const float fy = floorf(dy);
      const float pos = (float)(w + pad + k % 3 - 1) + dx;
      const float px = floorf(pos);
      en.wx0 = round_bf16(1.0f - (pos - px));
      en.wx1 = round_bf16(1.0f - ((px + 1.0f) - pos));
      en.wy0 = fmaxf(0.0f, 1.0f - fabsf(dy - fy));
      en.wy1 = fmaxf(0.0f, 1.0f - fabsf(dy - (fy + 1.0f)));
      en.m = raw_m[j];
      // image row h + ky + fy and column px - pad, less the window's origin
      // (h0 - r - 1, w0 - r - 1): both in [0, window - 2] for |d| <= r
      const int wr = ly + k / 3 + (int)fy + radius;
      const int wc = (int)px - w0 - 1;
      en.corner = (wr * ww + wc) * P;
      en.out = (p * KK + k) * C;
    }
    slots[lane] = en;
  };

  // the warp's 32 entries: lane -> pack q of entries lane / P, + 32 / P, ...
  auto blend_store = [&]() {
    const int q = lane % P;
    const int ch = cs0 + q * PACK;
    if (ch >= C) return;
    const int n = C - ch;
    const int row = ww * P;
    for (int j = lane / P; j < 32; j += 32 / P) {
      const Entry en = slots[j];
      if (en.out < 0) continue;
      const uint4* c0 = win + en.corner + q;
      float a[PACK], b[PACK], c[PACK], d[PACK];
      unpack(c0[0], a);
      unpack(c0[P], b);
      unpack(c0[row], c);
      unpack(c0[row + P], d);
      float acc[PACK];
#pragma unroll
      for (int t = 0; t < PACK; ++t) {
        // each row's horizontal blend, then the vertical weights, then the
        // mask, in the TPU kernel's order
        float g0 = 0.0f, g1 = 0.0f;
        g0 += en.wx0 * a[t];
        g0 += en.wx1 * b[t];
        g1 += en.wx0 * c[t];
        g1 += en.wx1 * d[t];
        acc[t] = (g0 * en.wy0 + g1 * en.wy1) * en.m;
      }
      BF* dst = out + en.out + ch;
      if constexpr (VEC) {
        const uint4 o =
            make_uint4(bf16x2(acc[0], acc[1]), bf16x2(acc[2], acc[3]),
                       bf16x2(acc[4], acc[5]), bf16x2(acc[6], acc[7]));
        __stcs(reinterpret_cast<int4*>(dst),
               *reinterpret_cast<const int4*>(&o));
      } else {
#pragma unroll
        for (int t = 0; t < PACK; ++t)
          if (t < n) dst[t] = __float2bfloat16_rn(acc[t]);
      }
    }
  };

  prefetch();
  fill();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {   // the warp's chunks of 32
    if (warp + j * warps >= chunks) break;
    entry(j);
    __syncwarp();
    blend_store();
    __syncwarp();
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// smem: the block's dynamic shared memory, from the caller's plan; refused
// where it is less than the window and the entry slots take.  A plan larger
// than the device allows fails at the launch.
template <typename T, int P, bool VEC>
int launch(const void* x, const float* offsets, const float* mask, BF* out,
           int H, int W, int C, int radius, int tile_h, int tile_w, int smem,
           cudaStream_t stream) {
  const size_t window = (size_t)(tile_h + 2 * radius + 3) *
                        (tile_w + 2 * radius + 3) * P * sizeof(uint4);
  const size_t need = window + (size_t)TPP * tile_h * tile_w * sizeof(Entry);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      allow_all_shared_memory<dcn_onehot_kernel<T, P, VEC>>();
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int tiles_h = (H + tile_h - 1) / tile_h;
  int tw_log2 = 0;
  while ((1 << tw_log2) < tile_w) ++tw_log2;
  const dim3 grid(tiles_h * tiles_w, (C + P * PACK - 1) / (P * PACK));
  dcn_onehot_kernel<T, P, VEC><<<grid, TPP * tile_h * tile_w, smem, stream>>>(
      static_cast<const T*>(x), offsets, mask, out, H, W, C, radius, tile_h,
      tw_log2, tiles_w);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int by_slice(const void* x, const float* offsets, const float* mask, BF* out,
             int H, int W, int C, int radius, int tile_h, int tile_w,
             int slice_c, int smem, cudaStream_t s) {
  switch (slice_c) {
    case 8:
      return launch<T, 1, VEC>(x, offsets, mask, out, H, W, C, radius, tile_h,
                               tile_w, smem, s);
    case 16:
      return launch<T, 2, VEC>(x, offsets, mask, out, H, W, C, radius, tile_h,
                               tile_w, smem, s);
    case 32:
      return launch<T, 4, VEC>(x, offsets, mask, out, H, W, C, radius, tile_h,
                               tile_w, smem, s);
    case 64:
      return launch<T, 8, VEC>(x, offsets, mask, out, H, W, C, radius, tile_h,
                               tile_w, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x); out is bfloat16 [H*W, 9*C], fewer
// than 2^31 elements.  From ops/cuda_dcn.py::plan_onehot: tile_h x tile_w
// pixels per block (a multiple of 32, at most 256; tile_w a power of two),
// slice_c channels per block (8, 16, 32 or 64) and smem_bytes of dynamic
// shared memory per block (at least the window and the entry slots).  Needs
// radius >= 0.  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for arguments it does not take); the kernel runs on
// `stream` and does not synchronise.
extern "C" int dcn_sample_onehot(const void* x, const void* offsets,
                                 const void* mask, void* out, int H, int W,
                                 int C, int radius, int dtype, int tile_h,
                                 int tile_w, int slice_c, int smem_bytes,
                                 void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || radius < 0 || tile_h <= 0 ||
      tile_w <= 0 || (tile_w & (tile_w - 1)) != 0 ||
      (tile_h * tile_w) % 32 != 0 || tile_h * tile_w > 256 ||
      (long long)H * W * KK * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  BF* o = static_cast<BF*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % PACK == 0 && aligned(x, 16) && aligned(out, 16);
  if (dtype == 0)
    return vec ? by_slice<float, true>(x, off, msk, o, H, W, C, radius, tile_h,
                                       tile_w, slice_c, smem_bytes, s)
               : by_slice<float, false>(x, off, msk, o, H, W, C, radius,
                                        tile_h, tile_w, slice_c, smem_bytes, s);
  if (dtype == 1)
    return vec ? by_slice<BF, true>(x, off, msk, o, H, W, C, radius, tile_h,
                                    tile_w, slice_c, smem_bytes, s)
               : by_slice<BF, false>(x, off, msk, o, H, W, C, radius, tile_h,
                                     tile_w, slice_c, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
