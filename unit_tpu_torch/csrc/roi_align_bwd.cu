// ROIAlignV2 backward (the gradient of the features) for Hopper (sm_90a).
//
// Replaces: unit_tpu/ops/roi_align_pallas_bwd.py::roi_align_backward_pallas_batched
// (kernels `_bwd_kernel_vmem_listed`, `_bwd_kernel_vmem`, `_bwd_kernel`), the
// custom_vjp backward of K1 (unit_tpu/ops/roi_align_pallas.py:295-314).
// It computes dF [B, H, W, C] = sum over ROIs, bins and s x s samples of
// g[b, n, ph, pw, c] / s^2 times the bilinear weight of each corner, with the
// forward's semantics (csrc/roi_align_fwd.cu): a sample outside
// [-1, H] x [-1, W] contributes nothing, coordinates are clamped to
// [0, H-1] x [0, W-1] and hi = min(lo + 1, size - 1), so a clamped sample puts
// its whole weight on the last row or column.  Sums are f32; the result is
// written once, in the dtype of g (the feature dtype: bf16 in the recipe).
//
// What bounds it on the card: 16 weighted adds per element of g (s^2 = 4
// samples x 4 corners), 3.3e9 for one train-step stream of the flagship
// (g = [2, 512, 14, 14, 1024] bf16, 411 MB, read from DRAM about once), and
// a scatter whose targets collide: many ROIs overlap every feature cell, and
// on the train path many ROIs pile onto a few rows (clustered proposals,
// boxes clipped flat against the image border).
// The design removes the collisions instead of resolving them with atomics
// ("owner computes"), and bounds the pile-ups by chunking the ROIs:
//   * pass 1: one warp per (ROI chunk of kChunk, image, feature row y, slice
//     of 64 channels); it keeps that row's [W, 64] f32 partial sum in shared
//     memory (21.5 KB at W = 84) and writes it once to an f32 scratch
//     [chunks, B, H, W, C];
//   * each lane owns two channels of the slice, so no two threads ever add
//     to the same word and no atomics are needed;
//   * the warp walks its chunk's ROIs in order; the lanes test one y-sample
//     each (P * s = 28 of them) and a ballot names the samples whose corner
//     rows include y; for those, the warp reads g[n, ph, :, slice] (two
//     bf16 per lane: 128 contiguous bytes per warp; the P loads of a bin row
//     are issued together) and adds the x-sample contributions of every bin
//     of that output row;
//   * blocks are numbered row-fastest, so the warps that read the same g
//     rows (the up to 2s feature rows one output row touches) run together
//     and share them through L2;
//   * pass 2 sums the chunks' partials in chunk order and writes dF once,
//     in the output dtype (a streaming pass over the scratch: ~0.55 GB for
//     the flagship stream, ~0.3 ms).
// A row whose ROIs pile up costs at most kChunk ROIs per warp, and the order
// of every sum is fixed, so the result is bit-identical from run to run,
// like the TPU's sequential grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSlice = 2 * kWarp;  // channels per block, two per lane
constexpr int kMaxP = 16;          // bins per row whose g loads are issued together
constexpr int kChunk = 32;         // ROIs per pass-1 warp

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  __device__ static float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

template <>
struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
};

// One bilinear sample coordinate along an axis of length `size` (as in
// csrc/roi_align_fwd.cu): low/high index, weights (1 - l, l), outside flag.
struct Sample {
  int lo;
  int hi;
  float wl;
  float wh;
  int oob;
};

__device__ __forceinline__ Sample make_sample(float v, int size) {
  Sample s;
  s.oob = (v < -1.f) || (v > (float)size);
  const float vc = fminf(fmaxf(v, 0.f), (float)(size - 1));
  const float v0 = floorf(vc);
  const float l = __fsub_rn(vc, v0);
  s.lo = (int)v0;
  s.hi = min(s.lo + 1, size - 1);
  s.wh = l;
  s.wl = __fsub_rn(1.f, l);
  return s;
}

// Sample position k along a ROI side, in the op order of the forward.
__device__ __forceinline__ float sample_pos(float start, float bin, int k, int s) {
  const float frac = __fdiv_rn(__fadd_rn((float)(k % s), 0.5f), (float)s);
  const float grid = __fadd_rn((float)(k / s), frac);
  return __fadd_rn(start, __fmul_rn(bin, grid));
}

// Adds one bin's gradient pair (times 1/s^2 and the y weight) to the
// accumulator at the two corner columns of each of the bin's s x-samples.
__device__ __forceinline__ void add_bin(float2* acc, const Sample* xs, int s, int lane,
                                        float wy, float2 gv, float inv) {
  const float gx = __fmul_rn(gv.x, inv);
  const float gy = __fmul_rn(gv.y, inv);
  for (int ix = 0; ix < s; ++ix) {
    const Sample sx = xs[ix];
    if (sx.oob) continue;
    const float wlo = __fmul_rn(wy, sx.wl);
    const float whi = __fmul_rn(wy, sx.wh);
    float2& lo = acc[sx.lo * kWarp + lane];
    lo.x += wlo * gx;
    lo.y += wlo * gy;
    float2& hi = acc[sx.hi * kWarp + lane];
    hi.x += whi * gx;
    hi.y += whi * gy;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarp)
roi_align_bwd_rows(const T* __restrict__ g, const float* __restrict__ rois,
                   float* __restrict__ part, int bsz, int n_rois, int h, int w, int c,
                   int p, int s, float scale) {
  extern __shared__ float smem[];
  float2* acc = reinterpret_cast<float2*>(smem);                  // [w][kWarp] pairs
  Sample* xs = reinterpret_cast<Sample*>(smem + (size_t)w * kSlice);  // [p * s]

  const int slices = (c + kSlice - 1) / kSlice;
  const int y = blockIdx.x % h;
  const int bc = blockIdx.x / h;
  const int cb = bc / slices;  // chunk * bsz + b
  const int b = cb % bsz;
  const int chunk = cb / bsz;
  const int lane = threadIdx.x;
  const int c2 = (bc % slices) * kSlice + 2 * lane;
  const bool active = c2 < c;  // c is even: c2 + 1 < c as well

  for (int x = 0; x < w; ++x) acc[x * kWarp + lane] = make_float2(0.f, 0.f);

  const int ps = p * s;
  const float inv = __fdiv_rn(1.f, (float)(s * s));
  const int n_end = min(n_rois, (chunk + 1) * kChunk);
  const float* roi = rois + ((size_t)b * n_rois + chunk * kChunk) * 4;
  const T* g_img = g + (size_t)b * n_rois * p * p * c + c2;

  for (int n = chunk * kChunk; n < n_end; ++n, roi += 4) {
    const float x1 = __fsub_rn(__fmul_rn(roi[0], scale), 0.5f);
    const float y1 = __fsub_rn(__fmul_rn(roi[1], scale), 0.5f);
    const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), 0.5f);
    const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), 0.5f);
    const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)p);
    const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)p);
    bool xs_ready = false;

    for (int k0 = 0; k0 < ps; k0 += kWarp) {
      // lane k tests y-sample k0 + lane: its weight on row y (wl if lo == y,
      // plus wh if hi == y; both when the clamp makes lo == hi == y)
      float wy = 0.f;
      bool hit = false;
      if (k0 + lane < ps) {
        const Sample sy = make_sample(sample_pos(y1, bin_h, k0 + lane, s), h);
        if (!sy.oob && (sy.lo == y || sy.hi == y)) {
          hit = true;
          wy = (sy.lo == y ? sy.wl : 0.f) + (sy.hi == y ? sy.wh : 0.f);
        }
      }
      unsigned int mask = __ballot_sync(0xffffffffu, hit);
      if (mask == 0u) continue;
      if (!xs_ready) {  // the ROI's x-samples, once per ROI that touches row y
        for (int k = lane; k < ps; k += kWarp) {
          xs[k] = make_sample(sample_pos(x1, bin_w, k, s), w);
        }
        __syncwarp();
        xs_ready = true;
      }
      while (mask != 0u) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1u;
        const float wyk = __shfl_sync(0xffffffffu, wy, src);
        if (!active) continue;
        const int ph = (k0 + src) / s;
        const T* g_row = g_img + ((size_t)n * p + ph) * p * c;
        if (p <= kMaxP) {  // issue the row's loads together, then add
          float2 gv[kMaxP];
#pragma unroll
          for (int pw = 0; pw < kMaxP; ++pw) {
            if (pw < p) gv[pw] = Pair<T>::load(g_row + (size_t)pw * c);
          }
#pragma unroll
          for (int pw = 0; pw < kMaxP; ++pw) {
            if (pw < p) add_bin(acc, xs + pw * s, s, lane, wyk, gv[pw], inv);
          }
        } else {
          for (int pw = 0; pw < p; ++pw) {
            add_bin(acc, xs + pw * s, s, lane, wyk, Pair<T>::load(g_row + (size_t)pw * c), inv);
          }
        }
      }
      __syncwarp();  // every lane is done with xs before the next ROI fills it
    }
  }

  if (active) {
    float* dst = part + (((size_t)chunk * bsz + b) * h + y) * w * c + c2;
    for (int x = 0; x < w; ++x) {
      *reinterpret_cast<float2*>(dst + (size_t)x * c) = acc[x * kWarp + lane];
    }
  }
}

// Pass 2: out = the sum of the chunks' partials, in chunk order.
template <typename T>
__global__ void roi_align_bwd_sum(const float2* __restrict__ part, T* __restrict__ out,
                                  size_t pairs, int chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    float2 acc = part[i];
    for (int r = 1; r < chunks; ++r) {
      const float2 v = part[(size_t)r * pairs + i];
      acc.x += v.x;
      acc.y += v.y;
    }
    Pair<T>::store(out + 2 * i, acc);
  }
}

template <typename T>
int launch(const void* g, const float* rois, void* out, float* part, int b, int n, int h,
           int w, int c, int p, int s, float scale, cudaStream_t st) {
  const size_t smem = (size_t)w * kSlice * sizeof(float) + (size_t)p * s * sizeof(Sample);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int slices = (c + kSlice - 1) / kSlice;
  const int chunks = (n + kChunk - 1) / kChunk;
  const unsigned int blocks =
      (unsigned int)chunks * (unsigned int)b * (unsigned int)slices * (unsigned int)h;
  roi_align_bwd_rows<T><<<blocks, kWarp, smem, st>>>(
      static_cast<const T*>(g), rois, part, b, n, h, w, c, p, s, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t pairs = (size_t)b * h * w * c / 2;
  const unsigned int sum_blocks = (unsigned int)((pairs + 255) / 256 < 132 * 16
                                                 ? (pairs + 255) / 256 : 132 * 16);
  roi_align_bwd_sum<T><<<sum_blocks, 256, 0, st>>>(
      reinterpret_cast<const float2*>(part), static_cast<T*>(out), pairs, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of ROI chunks: the wrapper allocates the f32 scratch
// [chunks, B, H, W, C] that pass 1 writes and pass 2 reads.
int roi_align_bwd_chunks(int n) { return (n + kChunk - 1) / kChunk; }

// dtype (of g and of the output): 0 = float32, 1 = bfloat16.  c must be even,
// n >= 1 and the pointers 8-byte aligned (the wrapper checks them, and the
// shared memory the row accumulator needs).  Returns cudaGetLastError().
int roi_align_bwd_launch(const void* g, int dtype, const float* rois, void* out, void* part,
                         int b, int n, int h, int w, int c, int p, int s, float scale,
                         void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(part);
  if (dtype == 0) return launch<float>(g, rois, out, scratch, b, n, h, w, c, p, s, scale, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(g, rois, out, scratch, b, n, h, w, c, p, s, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
