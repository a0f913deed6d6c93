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
// [H*W, 9*C] the kernels write
//
//   dx[corner, c]      += g * mask * wt_j
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
// Two routes, picked by ops/cuda_dcn.py::deform_sample_backward:
//
// * dcn_backward_tiled (radius >= 0, a plan from cuda_dcn.plan_backward; every
//   recipe line).  The least work is bytes: g read once (9x the size of x)
//   and dx written once.  The unclamped route below adds every sampled
//   element into dx with four global float atomics, 36 per dx element over
//   a DLA-34 frame; the L2 takes ~620 G float adds/s, scalar or float4
//   alike, so that alone is ~1.1 ms per 544x960 frame (PERF.md).  Shared
//   memory does not add floats natively either: sm_90 compiles atomicAdd on
//   a __shared__ float to a compare-and-swap loop (ATOMS.CAST.SPIN), at
//   best ~1.2 T updates/s.  So a block sums in shared memory with plain
//   adds, made race-free by ownership.  It takes a tile of TH x TW pixels
//   and, in turn, slice_run slices of CS channels, and works on the window
//   its corners can reach, rows h0 - r - 1 .. h0 + TH + r + 1 and the same
//   span of columns ((TH + 2r + 3) x (TW + 2r + 3) cells, the +1 corner
//   included even where its weight is 0: the one-sided difference reads
//   it):
//     - weigh, scan, sort (once a tile): each (pixel, tap) entry's weights
//       and window cell (the corner floor(pos)), binned by cell with
//       native integer shared-memory atomics and a scan;
//     - per slice, fill: x's window in shared memory in x's own dtype
//       (16-byte cp.async copies, zeros outside the image and past C), the
//       next slice's copied in while this one's scatter runs;
//     - sums, in entry order: groups of CS / 4 lanes, 4 channels a lane,
//       read each g row once (streaming loads, four entries a group in
//       flight) and stage it in shared memory, take the corners from the x
//       window and reduce the sums behind dmask and doffsets with
//       shuffles.  With one slice they are the outputs; with several each
//       slice writes its partial sums to a float32 workspace [slices,
//       H*W*9, 3] that dcn_backward_sum_slices adds in slice order, so
//       doffsets and dmask are free of atomics and give the same bits on
//       every call;
//     - scatter: a group owns a bin and adds its entries' four corner terms
//       in registers, then into a float32 dx window once.  Bins of one
//       (row, column) parity own disjoint 2x2 corner blocks, so in each of
//       four parity phases no two groups touch one window element;
//     - flush: one global add per window cell and 4 channels
//       (red.global.add.v4.f32, through atomicAdd on a float4), cells that
//       received nothing skipped: ~2-4 adds per dx element in place of 36;
//       their order varies, so dx's bits may differ from call to call.
//   No global atomic before the flush.  What bounds it on an H100: the
//   latency of the block's phases (tools/ablate_backward.py; PERF.md).
// * dcn_backward, the unclamped route (radius < 0, dcn_impl="gather", or no
//   plan that fits): one warp per (pixel, tap) entry, its lanes over the
//   channels, four global float32 atomicAdds into dx per sampled element,
//   the per-entry sums reduced with warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_common.cuh"

namespace {

using namespace dcn;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FILL_BATCH = 4;         // window packs in flight per thread
constexpr int SUMS_BATCH = 4;         // entries' g rows in flight per group
constexpr int TILED_THREADS = 512;    // threads of a tiled block
// tiled blocks whose registers an SM holds: 64 registers a thread
constexpr int TILED_BLOCKS_PER_SM = 65536 / (64 * TILED_THREADS);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the unclamped route: a warp per entry, global atomics ----------------

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

// ---- the tiled route: windows in shared memory ----------------------------

// 4 consecutive channels of a T: a float4 or 4 packed bf16
template <typename T> struct Four;
template <> struct Four<float> { using V = float4; };
template <> struct Four<__nv_bfloat16> { using V = uint2; };

__device__ __forceinline__ void unpack4(const float4& v, float f[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack4(const uint2& v, float f[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// 4 channels of g at `src` (n of them inside C), zeros past C; vec: all 4
// there and aligned.  g is read once: streaming loads.
__device__ __forceinline__ float4 load_g4(const float* __restrict__ src,
                                          int n, bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(src));
  float f[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) f[t] = t < n ? __ldcs(src + t) : 0.0f;
  return make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ uint2 load_g4(const __nv_bfloat16* __restrict__ src,
                                         int n, bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const uint2*>(src));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t u[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) u[t] = t < n ? __ldcs(s + t) : 0u;
  return make_uint2(u[0] | u[1] << 16, u[2] | u[3] << 16);
}

// 16 bytes of x at `src` (n elements of them inside C), zeros past C; vec:
// all there and 16-byte aligned.
__device__ __forceinline__ uint4 fetch16(const float* __restrict__ src,
                                         int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  float f[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) f[t] = t < n ? __ldg(src + t) : 0.0f;
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 fetch16(const __nv_bfloat16* __restrict__ src,
                                         int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t u[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) u[t] = t < n ? __ldg(s + t) : 0u;
  return make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16, u[4] | u[5] << 16,
                    u[6] | u[7] << 16);
}

// dst[0..3] += v, one vector reduction (red.global.add.v4.f32, sm_90's
// float4 atomicAdd from CUDA 12.1 on), else four scalar ones
__device__ __forceinline__ void add4(float* dst, const float4& v) {
#if (__CUDACC_VER_MAJOR__ > 12 ||                                   \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)) &&  \
    !defined(ABLATE_SCALAR_FLUSH)
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The block's shared memory, in this order (each part 16-byte aligned):
// the x window [cells][CS] TX, the float32 dx window [cells][CS], the
// tile's rows of g [entries][CS] TG, the entries' weights (ly, lx, mask,
// clamp bits) [entries] float4 and (window cell, entry index) [entries]
// int2, the entries ordered by window cell [entries] int, the bins' starts
// [cells + 1] int and their counters [cells] int.
// ops/cuda_dcn.py::backward_smem_bytes computes the same.
template <typename TX, typename TG, int CS>
__host__ __device__ constexpr size_t tiled_smem_bytes(size_t cells,
                                                      size_t entries) {
  return align16(cells * CS * sizeof(TX)) + cells * CS * sizeof(float) +
         entries * CS * sizeof(TG) +
         entries * (sizeof(float4) + sizeof(int2) + sizeof(int)) +
         align16((cells + 1) * sizeof(int)) + align16(cells * sizeof(int));
}

// grid: (tile, channel slice); block: TILED_THREADS threads; tile_h * tile_w a
// multiple of 32, tile_w = 1 << tw_log2; dynamic shared memory as
// tiled_smem_bytes.  partial: nullptr for one slice (the sums are the
// outputs), else the [slices, H*W*9, 3] workspace.
template <typename TX, typename TG, int CS>
__global__ void __launch_bounds__(TILED_THREADS, TILED_BLOCKS_PER_SM)
dcn_backward_tiled_kernel(const TG* __restrict__ g, const TX* __restrict__ x,
                          const float* __restrict__ offsets,
                          const float* __restrict__ mask,
                          float* __restrict__ dx, float* __restrict__ doffsets,
                          float* __restrict__ dmask,
                          float* __restrict__ partial, int H, int W, int C,
                          int radius, int tile_h, int tw_log2, int tiles_w,
                          int slices, int slice_run, bool vec_x, bool vec_g,
                          bool vec_dx) {
  using GV = typename Four<TG>::V;
  using XV = typename Four<TX>::V;
  constexpr int LPE = CS / 4;                   // lanes of a group
  constexpr int EPW = 32 / LPE;                 // groups of a warp
  constexpr int GROUPS = TILED_THREADS / LPE;         // groups of the block
  constexpr int EP = 16 / (int)sizeof(TX);      // x elements per 16 bytes
  constexpr int PPC = CS / EP;                  // x packs per window cell
  constexpr int QPC = CS / 4;                   // 4-channel packs per cell
  const int tile_w = 1 << tw_log2;
  const int wh = tile_h + 2 * radius + 3;       // window rows
  const int ww = tile_w + 2 * radius + 3;       // window columns
  const int cells = wh * ww;
  const int n_ent = (tile_h << tw_log2) * KK;   // entries of the tile
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  TX* xw = reinterpret_cast<TX*>(base);
  base += align16((size_t)cells * CS * sizeof(TX));
  float* dxw = reinterpret_cast<float*>(base);
  base += (size_t)cells * CS * sizeof(float);
  GV* gt = reinterpret_cast<GV*>(base);
  base += (size_t)n_ent * CS * sizeof(TG);
  float4* ew = reinterpret_cast<float4*>(base);
  base += (size_t)n_ent * sizeof(float4);
  int2* eid = reinterpret_cast<int2*>(base);
  base += (size_t)n_ent * sizeof(int2);
  int* order = reinterpret_cast<int*>(base);
  base += (size_t)n_ent * sizeof(int);
  int* bin = reinterpret_cast<int*>(base);
  base += align16((size_t)(cells + 1) * sizeof(int));
  int* count = reinterpret_cast<int*>(base);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ty = blockIdx.x / tiles_w;
  const int h0 = ty * tile_h;
  const int w0 = (blockIdx.x - ty * tiles_w) * tile_w;
  int slice = blockIdx.y * slice_run;           // the slice in hand
  int cs0 = slice * CS;
  const int row0 = h0 - radius - 1;             // the window's origin
  const int col0 = w0 - radius - 1;
  const int entries = H * W * KK;

  // x's window in its dtype, zeros outside the image and past C: copied
  // asynchronously (cp.async, 16 bytes a pack, zero-filled where nothing is
  // read; the caller waits) where every pack is whole and aligned, else
  // loaded and stored here
  auto fill = [&]() {
    uint4* xp = reinterpret_cast<uint4*>(xw);
    const int n_packs = cells * PPC;
    if (vec_x) {
      for (int i = threadIdx.x; i < n_packs; i += TILED_THREADS) {
        const int cell = i / PPC;
        const int wr = cell / ww;
        const int gr = row0 + wr;
        const int gc = col0 + cell - wr * ww;
        const int ch = cs0 + (i - cell * PPC) * EP;
        const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W && ch < C;
        const TX* src = in ? x + ((size_t)gr * W + gc) * C + ch : x;
        asm volatile(
            "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                (unsigned)__cvta_generic_to_shared(xp + i)),
            "l"(src), "r"(in ? 16 : 0));
      }
      asm volatile("cp.async.commit_group;\n" ::);
      return;
    }
    for (int i0 = threadIdx.x; i0 < n_packs;
         i0 += FILL_BATCH * TILED_THREADS) {
      uint4 v[FILL_BATCH];
#pragma unroll
      for (int b = 0; b < FILL_BATCH; ++b) {
        const int i = i0 + b * TILED_THREADS;
        const int cell = i / PPC;
        const int wr = cell / ww;
        const int gr = row0 + wr;
        const int gc = col0 + cell - wr * ww;
        const int ch = cs0 + (i - cell * PPC) * EP;
        v[b] = make_uint4(0, 0, 0, 0);
        if (i < n_packs && gr >= 0 && gr < H && gc >= 0 && gc < W && ch < C)
          v[b] = fetch16(x + ((size_t)gr * W + gc) * C + ch, C - ch, vec_x);
      }
#pragma unroll
      for (int b = 0; b < FILL_BATCH; ++b) {
        const int i = i0 + b * TILED_THREADS;
        if (i < n_packs) xp[i] = v[b];
      }
    }
  };

  // each entry's weights and window cell (today's route's position
  // arithmetic; the cell of corner floor(pos), whose 2x2 corner block lies
  // in the window for |offset| <= r), counted into its cell's bin
  auto weigh = [&]() {
    for (int el = threadIdx.x; el < n_ent; el += TILED_THREADS) {
      const int pix = el / KK;
      const int k = el - pix * KK;
      const int ly = pix >> tw_log2;
      const int h = h0 + ly;
      const int w = w0 + pix - (ly << tw_log2);
      float4 wt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int2 id = make_int2(-1, -1);
      if (h < H && w < W) {
        const size_t p = (size_t)h * W + w;
        const float r = (float)radius;
        const float dy = offsets[p * (2 * KK) + 2 * k];
        const float dxo = offsets[p * (2 * KK) + 2 * k + 1];
        const int pass = (dy >= -r && dy <= r ? 1 : 0) |
                         (dxo >= -r && dxo <= r ? 2 : 0);
        const float yy = (float)(h + k / 3 - 1) + fminf(fmaxf(dy, -r), r);
        const float xx = (float)(w + k % 3 - 1) + fminf(fmaxf(dxo, -r), r);
        const float y0f = floorf(yy);
        const float x0f = floorf(xx);
        wt = make_float4(yy - y0f, xx - x0f, mask[p * KK + k],
                         __int_as_float(pass));
        id = make_int2(((int)y0f - row0) * ww + ((int)x0f - col0),
                       (int)p * KK + k);
        atomicAdd(count + id.x, 1);
      }
      ew[el] = wt;
      eid[el] = id;
    }
  };

  // the bins' starts: an exclusive scan of the counts by warp 0, each lane
  // over a run of cells; the counts become the bins' cursors
  auto scan = [&]() {
    if (warp != 0) return;
    const int per = (cells + 31) / 32;
    const int b0 = min(lane * per, cells);
    const int b1 = min(b0 + per, cells);
    int sum = 0;
    for (int i = b0; i < b1; ++i) sum += count[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
    for (int i = b0; i < b1; ++i) {
      const int n = count[i];
      bin[i] = run;
      count[i] = run;
      run += n;
    }
    if (lane == 31) bin[cells] = incl;
  };

  // the entries ordered by window cell (native integer atomics)
  auto sort = [&]() {
    for (int el = threadIdx.x; el < n_ent; el += TILED_THREADS) {
      const int cell = eid[el].x;
      if (cell >= 0) order[atomicAdd(count + cell, 1)] = el;
    }
  };

  // per entry, in entry order: groups of LPE lanes, 4 channels a lane,
  // read g's row once (SUMS_BATCH entries a group in flight) into the
  // tile's rows of g, take the four corners from the x window, and reduce
  // the sums behind dmask and doffsets over the group with shuffles
  auto sums = [&]() {
    const int j = lane / LPE;
    const int q = lane - j * LPE;
    const int ch = cs0 + 4 * q;
    for (int el0 = warp * EPW + j; el0 < n_ent;
         el0 += SUMS_BATCH * GROUPS) {
      GV gv[SUMS_BATCH];
      int2 id[SUMS_BATCH];
#pragma unroll
      for (int u = 0; u < SUMS_BATCH; ++u) {
        const int el = el0 + u * GROUPS;
        id[u] = el < n_ent ? eid[el] : make_int2(-1, -1);
        gv[u] = GV{};
        if (id[u].y >= 0 && ch < C)
          gv[u] = load_g4(g + (size_t)id[u].y * C + ch, C - ch, vec_g);
      }
#pragma unroll
      for (int u = 0; u < SUMS_BATCH; ++u) {
        const int el = el0 + u * GROUPS;
        if (el >= n_ent) break;               // the same for the whole warp
        gt[el * QPC + q] = gv[u];
        float s_val = 0.0f, s_dy = 0.0f, s_dx = 0.0f;
        const float4 wt = ew[el];
        if (id[u].x >= 0) {
          const float ly = wt.x, lx = wt.y;
          const float hy = 1.0f - ly, hx = 1.0f - lx;
          const int c00 = id[u].x * CS + 4 * q;
          float a[4], b[4], c[4], d[4], gf[4];
          unpack4(*reinterpret_cast<const XV*>(xw + c00), a);
          unpack4(*reinterpret_cast<const XV*>(xw + c00 + CS), b);
          unpack4(*reinterpret_cast<const XV*>(xw + c00 + ww * CS), c);
          unpack4(*reinterpret_cast<const XV*>(xw + c00 + ww * CS + CS), d);
          unpack4(gv[u], gf);
          float s_top = 0.0f, s_bot = 0.0f, s_ba = 0.0f, s_dc = 0.0f;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            s_top += gf[t] * (hx * a[t] + lx * b[t]);
            s_bot += gf[t] * (hx * c[t] + lx * d[t]);
            s_ba += gf[t] * (b[t] - a[t]);
            s_dc += gf[t] * (d[t] - c[t]);
          }
          // the lane's part of sum_c g * bilinear and of the derivatives
          s_val = hy * s_top + ly * s_bot;
          s_dy = s_bot - s_top;
          s_dx = hy * s_ba + ly * s_dc;
        }
#pragma unroll
        for (int o = LPE / 2; o > 0; o >>= 1) {
          s_val += __shfl_xor_sync(0xffffffffu, s_val, o);
          s_dy += __shfl_xor_sync(0xffffffffu, s_dy, o);
          s_dx += __shfl_xor_sync(0xffffffffu, s_dx, o);
        }
        if (q == 0 && id[u].y >= 0) {
          const int e = id[u].y;
          const int pass = __float_as_int(wt.w);
          const float oy = (pass & 1) ? wt.z * s_dy : 0.0f;
          const float ox = (pass & 2) ? wt.z * s_dx : 0.0f;
          if (partial != nullptr) {
            float* o = partial + ((size_t)slice * entries + e) * 3;
            o[0] = s_val;
            o[1] = oy;
            o[2] = ox;
          } else {
            dmask[e] = s_val;
            doffsets[2 * e] = oy;
            doffsets[2 * e + 1] = ox;
          }
        }
      }
    }
  };

  // A group of LPE lanes, 4 channels a lane, owns a bin: it adds the four
  // corner terms of the bin's entries (g from the tile's rows) in
  // registers, then adds them into the dx window once.  The bins of one
  // (row, column) parity own disjoint 2x2 corner blocks, so within a parity
  // phase no two groups touch one window element: plain shared-memory
  // adds, no atomics.
  auto scatter = [&]() {
    const int grp = threadIdx.x / LPE;
    const int q = threadIdx.x - grp * LPE;
    for (int phase = 0; phase < 4; ++phase) {
      const int py = phase >> 1, px = phase & 1;
      // top-left cells lie in rows 0 .. wh - 2 and columns 0 .. ww - 2
      const int nby = (wh - py) / 2;
      const int nbx = (ww - px) / 2;
      for (int b = grp; b < nby * nbx; b += GROUPS) {
        const int by = b / nbx;
        const int t = (2 * by + py) * ww + 2 * (b - by * nbx) + px;
        const int s1 = bin[t + 1];
        int s = bin[t];
        if (s == s1) continue;
        float acc[4][4] = {};
        for (; s < s1; ++s) {
          const int el = order[s];
          const float4 wt = ew[el];
          const float ly = wt.x, lx = wt.y;
          const float hy = 1.0f - ly, hx = 1.0f - lx;
          const float f[4] = {hy * hx * wt.z, hy * lx * wt.z,
                              ly * hx * wt.z, ly * lx * wt.z};
          float gf[4];
          unpack4(gt[el * QPC + q], gf);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[i][k] += gf[k] * f[i];
        }
        const int c00 = t * CS + 4 * q;
        const int at[4] = {c00, c00 + CS, c00 + ww * CS, c00 + ww * CS + CS};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* p = reinterpret_cast<float4*>(dxw + at[i]);
          float4 v = *p;
          v.x += acc[i][0];
          v.y += acc[i][1];
          v.z += acc[i][2];
          v.w += acc[i][3];
          *p = v;
        }
      }
      __syncthreads();
    }
  };

  // the dx window into dx: one global add per cell and 4 channels, cells
  // outside the image and adds of zero skipped; the window is left zeroed
  // for the next slice
  auto flush = [&]() {
    float4* dp = reinterpret_cast<float4*>(dxw);
    for (int i = threadIdx.x; i < cells * QPC; i += TILED_THREADS) {
      const float4 v = dp[i];
      dp[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int cell = i / QPC;
      const int wr = cell / ww;
      const int gr = row0 + wr;
      const int gc = col0 + cell - wr * ww;
      const int ch = cs0 + (i - cell * QPC) * 4;
      if (gr < 0 || gr >= H || gc < 0 || gc >= W || ch >= C) continue;
      if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) continue;
      float* dst = dx + ((size_t)gr * W + gc) * C + ch;
      if (vec_dx) {
        add4(dst, v);
      } else {
        const float f[4] = {v.x, v.y, v.z, v.w};
        for (int u = 0; u < 4 && u < C - ch; ++u) atomicAdd(dst + u, f[u]);
      }
    }
  };

  // the tile's entries and bins once, then slice_run channel slices
  for (int i = threadIdx.x; i < cells; i += TILED_THREADS) count[i] = 0;
  __syncthreads();
  weigh();
  __syncthreads();
  scan();
  __syncthreads();
  sort();
  // the next slice's x window is copied in while this one's scatter runs
  // (the scatter does not read it); the flush leaves the dx window zeroed
  const int last = min(slice + slice_run, slices);
  for (int i = threadIdx.x; i < cells * QPC; i += TILED_THREADS)
    reinterpret_cast<float4*>(dxw)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  fill();
  for (; slice < last; ++slice) {
    cs0 = slice * CS;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    sums();
    __syncthreads();
    if (slice + 1 < last) {
      cs0 = (slice + 1) * CS;
      fill();
      cs0 = slice * CS;
    }
    scatter();
    flush();
  }
}

// doffsets and dmask from the slices' partial sums, added in slice order
__global__ void __launch_bounds__(THREADS)
dcn_backward_sum_slices(const float* __restrict__ partial,
                        float* __restrict__ doffsets,
                        float* __restrict__ dmask, int entries, int slices) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= entries) return;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int s = 0; s < slices; ++s) {
    const float* p = partial + ((size_t)s * entries + e) * 3;
    s0 += p[0];
    s1 += p[1];
    s2 += p[2];
  }
  dmask[e] = s0;
  doffsets[2 * e] = s1;
  doffsets[2 * e + 1] = s2;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename TX, typename TG, int CS>
int launch_tiled(const void* g, const void* x, const void* offsets,
                 const void* mask, void* dx, void* doffsets, void* dmask,
                 void* partial, int H, int W, int C, int radius, int tile_h,
                 int tile_w, int slice_run, int smem, cudaStream_t stream) {
  const size_t cells =
      (size_t)(tile_h + 2 * radius + 3) * (tile_w + 2 * radius + 3);
  const size_t need = tiled_smem_bytes<TX, TG, CS>(
      cells, (size_t)tile_h * tile_w * KK);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      allow_all_shared_memory<dcn_backward_tiled_kernel<TX, TG, CS>>();
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int tiles_h = (H + tile_h - 1) / tile_h;
  const int slices = (C + CS - 1) / CS;
  if ((slices > 1) != (partial != nullptr)) return (int)cudaErrorInvalidValue;
  int tw_log2 = 0;
  while ((1 << tw_log2) < tile_w) ++tw_log2;
  constexpr int EP = 16 / (int)sizeof(TX);
  const bool vec_x = C % EP == 0 && aligned(x, 16);
  const bool vec_g = C % 4 == 0 && aligned(g, 4 * sizeof(TG));
  const bool vec_dx = C % 4 == 0 && aligned(dx, 16);
  if (slice_run <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles_h * tiles_w, (slices + slice_run - 1) / slice_run);
  dcn_backward_tiled_kernel<TX, TG, CS><<<grid, TILED_THREADS, smem,
                                           stream>>>(
      static_cast<const TG*>(g), static_cast<const TX*>(x),
      static_cast<const float*>(offsets), static_cast<const float*>(mask),
      static_cast<float*>(dx), static_cast<float*>(doffsets),
      static_cast<float*>(dmask), static_cast<float*>(partial), H, W, C,
      radius, tile_h, tw_log2, tiles_w, slices, slice_run, vec_x, vec_g,
      vec_dx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return (int)e;
  const int entries = H * W * KK;
  dcn_backward_sum_slices<<<(entries + THREADS - 1) / THREADS, THREADS, 0,
                            stream>>>(static_cast<const float*>(partial),
                                      static_cast<float*>(doffsets),
                                      static_cast<float*>(dmask), entries,
                                      slices);
  return (int)cudaGetLastError();
}

template <typename TX, typename TG>
int tiled_by_slice(const void* g, const void* x, const void* offsets,
                   const void* mask, void* dx, void* doffsets, void* dmask,
                   void* partial, int H, int W, int C, int radius, int tile_h,
                   int tile_w, int slice_c, int slice_run, int smem,
                   cudaStream_t s) {
  switch (slice_c) {
    case 8:
      return launch_tiled<TX, TG, 8>(g, x, offsets, mask, dx, doffsets, dmask,
                                     partial, H, W, C, radius, tile_h, tile_w,
                                     slice_run, smem, s);
    case 16:
      return launch_tiled<TX, TG, 16>(g, x, offsets, mask, dx, doffsets,
                                      dmask, partial, H, W, C, radius, tile_h,
                                      tile_w, slice_run, smem, s);
    case 32:
      return launch_tiled<TX, TG, 32>(g, x, offsets, mask, dx, doffsets,
                                      dmask, partial, H, W, C, radius, tile_h,
                                      tile_w, slice_run, smem, s);
    case 64:
      return launch_tiled<TX, TG, 64>(g, x, offsets, mask, dx, doffsets,
                                      dmask, partial, H, W, C, radius, tile_h,
                                      tile_w, slice_run, smem, s);
  }
  return (int)cudaErrorInvalidValue;
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

// The tiled route, the same outputs as dcn_backward for radius >= 0.  From
// ops/cuda_dcn.py::plan_backward: tile_h x tile_w pixels per block (a
// multiple of 32; tile_w a power of two), slice_c channels per block (8, 16,
// 32 or 64) and smem_bytes of dynamic shared memory (at least the two
// windows and the entry slots).  partial: a float32 workspace of
// slices * H*W*9 * 3 elements where C needs more than one slice, else null.
// H*W*9*C must be below 2^31.  Returns the cudaError_t of the launches (0 on
// success; cudaErrorInvalidValue for arguments it does not take); the
// kernels run on `stream` and do not synchronise.
extern "C" int dcn_backward_tiled(const void* g, const void* x,
                                  const void* offsets, const void* mask,
                                  void* dx, void* doffsets, void* dmask,
                                  void* partial, int H, int W, int C,
                                  int radius, int x_dtype, int g_dtype,
                                  int tile_h, int tile_w, int slice_c,
                                  int slice_run, int smem_bytes,
                                  void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || radius < 0 || tile_h <= 0 ||
      tile_w <= 0 || (tile_w & (tile_w - 1)) != 0 ||
      (tile_h * tile_w) % 32 != 0 ||
      (long long)H * W * KK * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (x_dtype == 0 && g_dtype == 0)
    return tiled_by_slice<float, float>(g, x, offsets, mask, dx, doffsets,
                                        dmask, partial, H, W, C, radius,
                                        tile_h, tile_w, slice_c, slice_run,
                                        smem_bytes, s);
  if (x_dtype == 1 && g_dtype == 1)
    return tiled_by_slice<BF, BF>(g, x, offsets, mask, dx, doffsets, dmask,
                                  partial, H, W, C, radius, tile_h, tile_w,
                                  slice_c, slice_run, smem_bytes, s);
  if (x_dtype == 0 && g_dtype == 1)
    return tiled_by_slice<float, BF>(g, x, offsets, mask, dx, doffsets, dmask,
                                     partial, H, W, C, radius, tile_h, tile_w,
                                     slice_c, slice_run, smem_bytes, s);
  if (x_dtype == 1 && g_dtype == 0)
    return tiled_by_slice<BF, float>(g, x, offsets, mask, dx, doffsets, dmask,
                                     partial, H, W, C, radius, tile_h, tile_w,
                                     slice_c, slice_run, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
