// Fused modulated deformable 3x3 convolution (DCNv2 sampling + the [9C, Cout]
// weight product + bias) for NVIDIA Hopper, sm_90a, on the tensor cores.
//
// Replaces deft_tpu/ops/pallas_dcn.py::_dcn_kernel (via deform_conv_pallas),
// which samples a row tile into VMEM and multiplies it by the weight inside
// the kernel body (pallas_dcn.py:263-267), so the patches never reach device
// memory.  Its function: x rounded to bfloat16 (the TPU kernel's slab,
// :297), the clamped bilinear sampling times the mask in float32, the float32
// product with the float32 weight, plus the bias, out in x's dtype.
//
// Layouts: x [H, W, C] bfloat16 (the wrapper rounds a float32 x to bfloat16
// first, as deform_conv_pallas does outside its kernel, :297), offsets
// [H, W, 9, 2] float32 (dy, dx), mask [H, W, 9] float32, weight [9C, Cout]
// float32 tap-major, bias [Cout] float32, out [H*W, Cout] float32 or
// bfloat16 (x's dtype), workspace [splits, H*W, Cout] float32 (only for
// splits > 1).
//
// What bounds it: operations, at the tensor cores' rate in 3xTF32.  It moves
// only x, the offsets, the mask, the weight and the output (~177 MB per frame
// over the 16 DCNv2 layers of DLA-34 at 544x960, 0.053 ms at 3.35 TB/s) but
// does 2 * H*W * 9C * Cout multiply-adds (28.3 GFLOP per frame), three times
// over in TF32: at least 0.17 ms at the H100's 495 TFLOP/s.
//
// Why 3xTF32: one TF32 pass keeps 10 bits of each operand and misses the
// float32 product by ~3e-4 of max|out| at K = 4608, above the 1e-4 the
// function is held to.  Each float32 operand v is split into hi = tf32(v)
// and lo = tf32(v - hi), both rounded to nearest with ties away from zero
// as cvt.rna.tf32.f32 rounds (done with two integer operations, which for
// finite v give cvt.rna's bits off the conversion pipe), and each fragment
// pair issues three MMAs, lo*hi + hi*lo + hi*hi, into one float32
// accumulator: the product of two 21-bit mantissas, within ~1e-7 of the
// float32 SGEMM.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  The
// sampler splits each A value once, into hi and lo planes of the A stage
// (every warp of a block row reads them); B fragments split in registers.
// The weight is used as it lies, N-major [9C, Cout]; TF32 wgmma would need
// both operands K-major in shared memory, so a transposed copy of every
// weight tile.  wgmma with a TMA weight ring is the next step.
//
// Design:
//   * one block owns BM output pixels x BN output channels, BN = 64, 128 or
//     256 so that one column tile holds all of a DLA-34 layer's Cout: each
//     sample is computed once.  8 warps, each a 32 x 16 or 32 x 32 tile of
//     m16n8 MMAs.  Phase 1 computes the four corner indices and mask-folded
//     weights of every (pixel, tap) of its pixels into shared memory
//     (dcn_common.cuh, the same float operations as dcn_sample.cu);
//   * the block walks its share of the 9C reduction in BK = 32 chunks, two
//     shared-memory stages deep: while the warps run the MMAs of chunk i,
//     cp.async streams the [BK, BN] weight tile of chunk i + 1 into the other
//     stage and each thread's gathers of chunk i + 1's corners are in
//     flight (16-byte loads of 8 bf16 channels); the bilinear blend of those
//     corners, split into hi and lo, is written to the other A stage after
//     the MMAs.  One barrier per chunk.  A rows are padded to
//     BK + 4 floats, B rows to BN + 8, so fragment loads are conflict-free;
//     K past 9C and columns past Cout are zero-filled in shared memory;
//   * split-K fills the card: ops/cuda_dcn.py::plan_fused splits the chunks
//     into `splits` equal runs (blockIdx.z) where the pixel tiles alone
//     leave SMs idle.  With one split the block adds
//     the bias and writes x's dtype; otherwise it writes its float32 partial
//     to the workspace and reduce_splits sums the partials in split order,
//     adds the bias and converts.  No atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_common.cuh"

namespace {

using namespace dcn;

constexpr int BK = 32;              // reduction chunk
constexpr int THREADS = 256;        // 8 warps
constexpr int A_STRIDE = BK + 4;    // floats per A row in shared memory

// Block tile BM x BN over a WM x (8 / WM) grid of warps.
template <int BM_, int BN_, int WM_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = 8 / WM_;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // m16 x n8 MMA tiles
  static constexpr int B_STRIDE = BN + 8;
  static constexpr int A_FLOATS = BM * A_STRIDE, B_FLOATS = BK * B_STRIDE;
  // two stages of A (hi and lo planes) and B, then phase 1's table
  static constexpr int SMEM = (4 * A_FLOATS + 2 * B_FLOATS) * 4 +
                              BM * KK * 4 * (sizeof(int) + sizeof(float));
};
using Tile64 = Tile<64, 64, 2>;     // warp tile 32 x 16
using Tile128 = Tile<64, 128, 2>;   // warp tile 32 x 32
using Tile256 = Tile<32, 256, 1>;   // warp tile 32 x 32

// cvt.rna.tf32.f32 for finite v: add half of the 13 dropped bits to the
// magnitude, then clear them
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a * b for one m16n8k8 tile, float32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `bytes` (16 or 4) from global to shared memory asynchronously,
// zero-filling what lies past `src_bytes`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// V: channels per gather (8 where C and x allow 16-byte packs, else 1).
// wvec: 16-byte weight copies (Cout % 4 == 0 and an aligned weight).
// T: the output's type.
template <typename T, int V, class G>
__global__ void __launch_bounds__(THREADS, 2)
dcn_fused_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ offsets,
                 const float* __restrict__ mask,
                 const float* __restrict__ weight,
                 const float* __restrict__ bias, T* __restrict__ out,
                 float* __restrict__ ws, int H, int W, int C, int Cout,
                 int radius, int chunks_per_split, bool wvec) {
  constexpr int BM = G::BM, BN = G::BN;
  constexpr int NV = BM * BK / V;                       // gathers a chunk
  constexpr int ITEMS = (NV + THREADS - 1) / THREADS;   // ... per thread
  static_assert(BM * BK % V == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* As = reinterpret_cast<uint32_t*>(smem);   // [stage][hi, lo]
  float* Bs = reinterpret_cast<float*>(As + 4 * G::A_FLOATS);
  int(*s_idx)[4] = reinterpret_cast<int(*)[4]>(Bs + 2 * G::B_FLOATS);
  float(*s_w)[4] = reinterpret_cast<float(*)[4]>(s_idx + BM * KK);

  const int tid = threadIdx.x;
  const int hw = H * W;
  const int K = KK * C;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int npix = min(BM, hw - p0);
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min((K + BK - 1) / BK, c_begin + chunks_per_split);

  // phase 1: corner indices and mask-folded weights per (pixel, tap)
  for (int e = tid; e < BM * KK; e += THREADS) {
    const int pl = e / KK;
    if (pl < npix) {
      bilinear_corners(offsets, mask, p0 + pl, e - pl * KK, H, W, radius,
                       s_idx[e], s_w[e]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_idx[e][j] = 0;
        s_w[e][j] = 0.0f;
      }
    }
  }
  __syncthreads();

  // the sampler: item it of this thread is A row flat / (BK / V), columns
  // (flat % (BK / V)) * V + [0, V)
  using P = Pack<__nv_bfloat16, V>;
  P g[ITEMS][4];
  int ent[ITEMS];     // (pixel, tap) entry of the item, -1 past 9C
  auto gather = [&](int chunk) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int flat = tid + it * THREADS;
      const int row = flat / (BK / V);
      const int k = chunk * BK + (flat % (BK / V)) * V;
      ent[it] = -1;
      if (flat < NV && k < K) {
        const int tap = k / C;
        const int c = k - tap * C;
        const int e = row * KK + tap;
        ent[it] = e;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          g[it][j] = *reinterpret_cast<const P*>(
              x + (size_t)s_idx[e][j] * C + c);
      }
    }
  };
  auto blend_store = [&](int stage) {
    uint32_t* hi = As + 2 * stage * G::A_FLOATS;
    uint32_t* lo = hi + G::A_FLOATS;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int flat = tid + it * THREADS;
      if (flat >= NV) break;
      const int at = flat / (BK / V) * A_STRIDE + (flat % (BK / V)) * V;
      float v[V];
#pragma unroll
      for (int t = 0; t < V; ++t) v[t] = 0.0f;
      if (ent[it] >= 0) {
        const int e = ent[it];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wj = s_w[e][j];
          float f[V];
          pack_to_float<false>(g[it][j], f);
#pragma unroll
          for (int t = 0; t < V; ++t) v[t] += wj * f[t];
        }
      }
      uint32_t h[V], l[V];
#pragma unroll
      for (int t = 0; t < V; ++t) split_tf32(v[t], h[t], l[t]);
      if constexpr (V == 8) {
        uint4* hv = reinterpret_cast<uint4*>(&hi[at]);
        uint4* lv = reinterpret_cast<uint4*>(&lo[at]);
        hv[0] = make_uint4(h[0], h[1], h[2], h[3]);
        hv[1] = make_uint4(h[4], h[5], h[6], h[7]);
        lv[0] = make_uint4(l[0], l[1], l[2], l[3]);
        lv[1] = make_uint4(l[4], l[5], l[6], l[7]);
      } else {
        hi[at] = h[0];
        lo[at] = l[0];
      }
    }
  };
  // the [BK, BN] weight tile of a chunk, zero past 9C and past Cout
  auto load_b = [&](int chunk, int stage) {
    float* B = Bs + stage * G::B_FLOATS;
    const int k0 = chunk * BK;
    if (wvec) {
      for (int i = tid; i < BK * BN / 4; i += THREADS) {
        const int kk = i / (BN / 4);
        const int n = (i - kk * (BN / 4)) * 4;
        const bool ok = k0 + kk < K && n0 + n < Cout;
        cp_async16(&B[kk * G::B_STRIDE + n],
                   ok ? weight + (size_t)(k0 + kk) * Cout + n0 + n : weight,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN;
        const int n = i - kk * BN;
        const bool ok = k0 + kk < K && n0 + n < Cout;
        cp_async4(&B[kk * G::B_STRIDE + n],
                  ok ? weight + (size_t)(k0 + kk) * Cout + n0 + n : weight,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // the MMAs of one chunk: fragments per the PTX m16n8k8 TF32 layout
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;        // groupID
  const int tg = lane & 3;         // thread in group
  const int wm = warp % G::WM;
  const int wn = warp / G::WM;
  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  auto mma_chunk = [&](int stage) {
    const uint32_t* A =
        As + 2 * stage * G::A_FLOATS + wm * G::WTM * A_STRIDE;
    const float* B = Bs + stage * G::B_FLOATS + wn * G::WTN;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t ahi[G::MT][4], alo[G::MT][4];
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const uint32_t* a = A + (mt * 16 + gr) * A_STRIDE + ks + tg;
        const int at[4] = {0, 8 * A_STRIDE, 4, 8 * A_STRIDE + 4};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[mt][i] = a[at[i]];
          alo[mt][i] = a[at[i] + G::A_FLOATS];
        }
      }
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const float* b = B + (ks + tg) * G::B_STRIDE + nt * 8 + gr;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[0], bh0, bl0);
        split_tf32(b[4 * G::B_STRIDE], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          mma_tf32(acc[mt][nt], alo[mt], bh0, bh1);
          mma_tf32(acc[mt][nt], ahi[mt], bl0, bl1);
          mma_tf32(acc[mt][nt], ahi[mt], bh0, bh1);
        }
      }
    }
  };

  // two stages: chunk i's MMAs overlap chunk i + 1's copies and gathers
  load_b(c_begin, 0);
  gather(c_begin);
  blend_store(0);
  cp_async_wait_all();
  __syncthreads();
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int cur = (chunk - c_begin) & 1;
    const bool next = chunk + 1 < c_end;
    if (next) {
      load_b(chunk + 1, cur ^ 1);
      gather(chunk + 1);
    }
    mma_chunk(cur);
    if (next) blend_store(cur ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (mt, nt, i): row gr + 8 * (i >> 1), column 2 * tg + (i & 1)
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + wm * G::WTM + mt * 16 + gr + 8 * (i >> 1);
        const int n = n0 + wn * G::WTN + nt * 8 + 2 * tg + (i & 1);
        if (p >= hw || n >= Cout) continue;
        if (ws != nullptr) {
          ws[((size_t)blockIdx.z * hw + p) * Cout + n] = acc[mt][nt][i];
        } else {
          from_float(acc[mt][nt][i] + bias[n], &out[(size_t)p * Cout + n]);
        }
      }
    }
  }
}

// out = sum of the split partials in split order, plus the bias; one
// thread per output element
template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int total, int Cout,
                              int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = ws[i];
  for (int z = 1; z < splits; ++z) s += ws[(size_t)z * total + i];
  from_float(s + bias[i % Cout], &out[i]);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int V, class G>
int launch(const void* x, const float* offsets, const float* mask,
           const float* weight, const float* bias, void* out, float* ws,
           int H, int W, int C, int Cout, int radius, int splits,
           int chunks_per_split, cudaStream_t stream) {
  auto kernel = dcn_fused_kernel<T, V, G>;
  // above 48 KB of dynamic shared memory; set on every launch (it is
  // cheap), so that it holds on every device and thread
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int hw = H * W;
  const dim3 grid((hw + G::BM - 1) / G::BM, (Cout + G::BN - 1) / G::BN,
                  splits);
  const bool wvec = Cout % 4 == 0 && aligned(weight, 16);
  kernel<<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), offsets, mask, weight, bias,
      static_cast<T*>(out), splits > 1 ? ws : nullptr, H, W, C, Cout, radius,
      chunks_per_split, wvec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int total = hw * Cout;
  reduce_splits<T><<<(total + 255) / 256, 256, 0, stream>>>(
      ws, bias, static_cast<T*>(out), total, Cout, splits);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int by_tile(int bn, const void* x, const float* offsets, const float* mask,
            const float* weight, const float* bias, void* out, float* ws,
            int H, int W, int C, int Cout, int radius, int splits,
            int chunks_per_split, cudaStream_t s) {
  switch (bn) {
    case 64:
      return launch<T, V, Tile64>(x, offsets, mask, weight, bias, out, ws, H,
                                  W, C, Cout, radius, splits,
                                  chunks_per_split, s);
    case 128:
      return launch<T, V, Tile128>(x, offsets, mask, weight, bias, out, ws, H,
                                   W, C, Cout, radius, splits,
                                   chunks_per_split, s);
    case 256:
      return launch<T, V, Tile256>(x, offsets, mask, weight, bias, out, ws, H,
                                   W, C, Cout, radius, splits,
                                   chunks_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: bfloat16.  dtype: 0 = float32, 1 = bfloat16 (of out).  radius >= 0.
// The plan (ops/cuda_dcn.py::plan_fused): bn in {64, 128, 256} output channels per
// block; the ceil(9C / 32) reduction chunks in `splits` runs of
// `chunks_per_split`, each run non-empty; a float32 workspace of splits *
// H*W * Cout elements when splits > 1.  Returns the cudaError_t of the
// launches (0 on success); the kernels run on `stream` and do not
// synchronise.
extern "C" int dcn_fused(const void* x, const void* offsets, const void* mask,
                         const void* weight, const void* bias, void* out,
                         void* workspace, int H, int W, int C, int Cout,
                         int radius, int dtype, int bn, int splits,
                         int chunks_per_split, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || radius < 0 || splits < 1 ||
      chunks_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (KK * C + BK - 1) / BK;
  if ((splits - 1) * chunks_per_split >= nchunks ||
      splits * chunks_per_split < nchunks ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  const bool v8 = C % 8 == 0 && aligned(x, 16);
  if (dtype == 0)
    return v8 ? by_tile<float, 8>(bn, x, off, msk, wt, b, out, ws, H, W, C,
                                  Cout, radius, splits, chunks_per_split, s)
              : by_tile<float, 1>(bn, x, off, msk, wt, b, out, ws, H, W, C,
                                  Cout, radius, splits, chunks_per_split, s);
  if (dtype == 1)
    return v8 ? by_tile<BF, 8>(bn, x, off, msk, wt, b, out, ws, H, W, C, Cout,
                               radius, splits, chunks_per_split, s)
              : by_tile<BF, 1>(bn, x, off, msk, wt, b, out, ws, H, W, C, Cout,
                               radius, splits, chunks_per_split, s);
  return (int)cudaErrorInvalidValue;
}
