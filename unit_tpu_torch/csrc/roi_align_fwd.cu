// ROIAlignV2 forward (aligned=True) for Hopper (sm_90a).
//
// Replaces: unit_tpu/ops/roi_align_pallas.py::roi_align_pallas_batched
// (`_forward`, kernels `_kernel_vmem` and `_kernel`).  Semantics are those of
// unit_tpu/ops/roi_align.py:29-95: ROI corners are scaled and shifted by
// -0.5, every output bin averages s x s bilinear samples, a sample with
// y < -1, y > H, x < -1 or x > W contributes zero, coordinates are clamped to
// [0, H-1] x [0, W-1] and hi = min(lo + 1, size - 1), so a clamped sample puts
// both corners on the last row or column (the Pallas kernel's "clamp y0 to
// H-2 and set ly = 1" is the same for every H >= 2).  A NaN coordinate samples
// index 0 with weight 1 (fmaxf/fminf drop the NaN), as the plain version does.
// Features [B, H, W, C] channels-last (f32 or bf16), ROIs [B, N, 4] f32 ->
// pooled [B, N, P, P, C] in the feature dtype.
//
// What bounds it on the card: no matmul, only gathers.  The feature map (a
// [50, 84, 1024] bf16 map is 8.6 MB) stays in the 50 MB L2, and the pooled
// output of the flagship (1000 x 14 x 14 x 1024 bf16, 401 MB) is the only
// DRAM-sized stream.  A kernel that gathers sample by sample reads s*s*4
// channel rows a bin in 4-byte pieces, 4.7 GB through L1/L2 for those 401 MB:
// the load instructions and the L2 set its time, and only then the store.  So
// the design reads fewer bytes, in wider pieces, and still writes each output
// element once:
//   * the sum is separable (as in csrc/roi_align_bwd.cu): a sample's weight on
//     a cell is a y-factor times an x-factor, and a sample outside on either
//     axis weighs 0 on that axis, so for one ROI
//         out[ph, pw, c] = sum_x Wx[pw, x] * (sum_y Wy[ph, y] * F[y, x, c])
//     with Wy[ph, y] the summed weight of bin ph's s y-samples on row y times
//     1/s (at most 2s taps, fewer where corners coincide), and Wx likewise;
//   * one block per (image, ROI) and slice of channels walks the ROI's P
//     output rows.  Once, it merges every bin's y-taps and x-taps into shared
//     memory (the tap merge of the backward's tables, so the coordinates keep
//     the op order of _roi_sample_coords), and lists the distinct columns the
//     x-taps name (a flag per column, one warp's ballot scan): at most
//     min(W, 2 s P).  A block per output row pays that prologue and its
//     barriers P times over and is bound by them, not by its loads;
//   * per output row, pass 1: for every listed column a thread loads the <= 2s
//     tap rows of its channels, 16 bytes each (8 bf16 or 4 f32 channels: a
//     warp reads 512 contiguous bytes of one feature cell), the loads of two
//     columns in flight together, and leaves T[x, c] = sum_y Wy * F[y, x, c]
//     in shared memory in f32.  Neighbouring output rows share feature rows,
//     which the same block read a moment earlier;
//   * one barrier; pass 2: out[ph, pw, c] = sum_x Wx[pw, x] * T[x, c] over the
//     bin's taps, rounded once to the feature dtype and stored once, 16 bytes
//     a thread; one barrier before the next row overwrites T.  Everything
//     stays f32 between the load and the one store (the TPU kernel
//     `_kernel_vmem` rounds its staged rows to the feature dtype before its
//     x-matmul; unit_tpu's XLA path does not, and neither does this).
// An output row then reads (distinct rows) x (distinct columns) cells once
// instead of 16 corners a bin.  What is left: the widening and multiply-adds
// of both passes, the traffic of the sums through shared memory (every output
// vector reads <= 2s of them, 32 bytes each) and two barriers a row; the time
// no longer depends on the ROI layout.  C that is not a multiple of the 16-byte vector, or a pointer that
// is not 16-byte aligned, takes the same kernel with two channels a thread (4
// or 8 bytes).  The order of every sum is fixed by the taps, so the result is
// bit-identical from launch to launch and does not depend on the slice or
// the block size.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSmemLimit = 232448;  // the most shared memory a block can use on sm_90
// A block's most threads, and the blocks of that size an SM must hold: three
// blocks of 256 threads at the flagship's 57 KB of sums a block, so at most 80
// registers a thread (two more registers cost a block an SM and 10% of time).
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 3;

// One merged corner of a bin along an axis: row or column (-1: unused), weight.
struct __align__(8) Tap {
  int idx;
  float w;
};

// V neighbouring channels of one thread: loaded as they lie in memory (Raw),
// multiplied into f32 sums, and stored rounded once.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  typedef float4 Raw;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void fma(float wgt, Raw r, float* acc) {
    acc[0] = fmaf(wgt, r.x, acc[0]);
    acc[1] = fmaf(wgt, r.y, acc[1]);
    acc[2] = fmaf(wgt, r.z, acc[2]);
    acc[3] = fmaf(wgt, r.w, acc[3]);
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 2> {
  typedef float2 Raw;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
  __device__ static void fma(float wgt, Raw r, float* acc) {
    acc[0] = fmaf(wgt, r.x, acc[0]);
    acc[1] = fmaf(wgt, r.y, acc[1]);
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

__device__ __forceinline__ float2 widen(unsigned int two_bf16) {
  return make_float2(__uint_as_float(two_bf16 << 16), __uint_as_float(two_bf16 & 0xffff0000u));
}

__device__ __forceinline__ unsigned int narrow(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&r);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  typedef uint4 Raw;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void fma(float wgt, Raw r, float* acc) {
    const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = widen(u[i]);
      acc[2 * i] = fmaf(wgt, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(wgt, f.y, acc[2 * i + 1]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(narrow(v[0], v[1]), narrow(v[2], v[3]),
                                              narrow(v[4], v[5]), narrow(v[6], v[7]));
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  typedef unsigned int Raw;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static void fma(float wgt, Raw r, float* acc) {
    const float2 f = widen(r);
    acc[0] = fmaf(wgt, f.x, acc[0]);
    acc[1] = fmaf(wgt, f.y, acc[1]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<unsigned int*>(p) = narrow(v[0], v[1]);
  }
};

// The f32 sums T[column j][vector v] of a block in shared memory, V floats
// each, laid out so that neighbouring threads touch neighbouring 16 bytes (8
// for V = 2): [j][V / 4][vpc][4].  `vpc` = vectors a column in this block.
template <int V>
__device__ __forceinline__ void tile_store(float* tile, int j, int v, int vpc, const float* acc) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(tile + ((size_t)j * vpc + v) * 2) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      *reinterpret_cast<float4*>(tile + (((size_t)j * (V / 4) + q) * vpc + v) * 4) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
}

template <int V>
__device__ __forceinline__ void tile_fma(const float* tile, int j, int v, int vpc, float wgt,
                                         float* acc) {
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(tile + ((size_t)j * vpc + v) * 2);
    acc[0] = fmaf(wgt, t.x, acc[0]);
    acc[1] = fmaf(wgt, t.y, acc[1]);
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t =
          *reinterpret_cast<const float4*>(tile + (((size_t)j * (V / 4) + q) * vpc + v) * 4);
      acc[4 * q] = fmaf(wgt, t.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(wgt, t.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(wgt, t.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(wgt, t.w, acc[4 * q + 3]);
    }
  }
}

// One bilinear sample coordinate along an axis of length `size`:
// low/high integer index, weights (1 - l, l), and whether it lies outside.
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

// Sample position k along a ROI side: start + bin * (k/s + (k%s + 0.5)/s),
// in the op order of unit_tpu/ops/roi_align.py::_roi_sample_coords.
__device__ __forceinline__ float sample_pos(float start, float bin, int k, int s) {
  const float frac = __fdiv_rn(__fadd_rn((float)(k % s), 0.5f), (float)s);
  const float grid = __fadd_rn((float)(k / s), frac);
  return __fadd_rn(start, __fmul_rn(bin, grid));
}

// A ROI side in feature coordinates: its start and its bin size.
__device__ __forceinline__ void roi_side(const float* roi, int axis, float scale, int p,
                                         float* start, float* bin) {
  const float a = __fsub_rn(__fmul_rn(roi[axis], scale), 0.5f);
  const float z = __fsub_rn(__fmul_rn(roi[axis + 2], scale), 0.5f);
  *start = a;
  *bin = __fdiv_rn(__fsub_rn(z, a), (float)p);
}

// The taps of bin `bin` of one ROI side into e[0 .. 2s): the bin's 2s corner
// weights, each times 1/s, duplicates summed, the used taps first, the unused
// ones marked with index -1 (as roi_align_bwd_tables of the backward).
__device__ void bin_taps(Tap* e, float start, float side, int bin, int size, int s) {
  const float inv = __fdiv_rn(1.f, (float)s);
  int cnt = 0;
  for (int j = 0; j < s; ++j) {
    const Sample sm = make_sample(sample_pos(start, side, bin * s + j, s), size);
    if (sm.oob) continue;
    for (int corner = 0; corner < 2; ++corner) {
      const int idx = corner ? sm.hi : sm.lo;
      const float wgt = __fmul_rn(corner ? sm.wh : sm.wl, inv);
      int k = 0;
      while (k < cnt && e[k].idx != idx) ++k;
      if (k < cnt) {
        e[k].w = __fadd_rn(e[k].w, wgt);
      } else {
        e[cnt].idx = idx;
        e[cnt].w = wgt;
        ++cnt;
      }
    }
  }
  for (; cnt < 2 * s; ++cnt) {
    e[cnt].idx = -1;
    e[cnt].w = 0.f;
  }
}

// Bytes of dynamic shared memory of one block: the f32 sums [cap][slice], the
// x-taps and y-taps [2][p][2s], the column list [cap] and the columns' slots
// [w].  `cap` = min(w, 2 s p), the most distinct columns a ROI's taps can name.
size_t smem_bytes(int w, int p, int s, int slice) {
  const size_t cap = (size_t)(w < 2 * s * p ? w : 2 * s * p);
  return cap * slice * sizeof(float) + (size_t)p * 4 * s * sizeof(Tap) +
         (cap + (size_t)w) * sizeof(int);
}

// Grid: x = image * N + ROI, y = slice of `slice` channels (a multiple of V).
// V = channels a thread loads at once; kS = the sampling ratio when it is
// known at compile time (the tap rows of two columns are then loaded
// together), 0 for any other.
template <typename T, int V, int kS>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                     T* __restrict__ out, int n_rois, int h, int w, int c, int p,
                                     int s, float scale, int slice, int cap) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_cols;
  const int taps = kS ? 2 * kS : 2 * s;
  float* tile = smem;                                            // [cap][slice] f32
  Tap* xtab = reinterpret_cast<Tap*>(tile + (size_t)cap * slice);  // [p][taps]
  Tap* ytab = xtab + (size_t)p * taps;                           // [p][taps]
  int* cols = reinterpret_cast<int*>(ytab + (size_t)p * taps);   // [cap], times c
  int* slot = cols + cap;                                        // [w]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int bn = blockIdx.x;  // b * n_rois + n
  const int b = bn / n_rois;
  const int c0 = blockIdx.y * slice;
  const int vpc = min(slice, c - c0) / V;  // vectors a column in this block
  const float* roi = rois + (size_t)bn * 4;

  // the taps of every bin along x and along y; no column listed yet
  for (int k = tid; k < 2 * p; k += nthr) {
    const int axis = k < p ? 0 : 1;
    const int bin = k - axis * p;
    float start, side;
    roi_side(roi, axis, scale, p, &start, &side);
    bin_taps((axis ? ytab : xtab) + (size_t)bin * taps, start, side, bin, axis ? h : w, s);
  }
  for (int x = tid; x < w; x += nthr) slot[x] = 0;
  __syncthreads();
  // the distinct columns of the x-taps, in ascending order: flag, then scan
  for (int k = tid; k < p * taps; k += nthr) {
    const int idx = xtab[k].idx;
    if (idx >= 0) slot[idx] = 1;
  }
  __syncthreads();
  if (tid < kWarp) {
    int count = 0;
    for (int x0 = 0; x0 < w; x0 += kWarp) {
      const int x = x0 + tid;
      const bool used = x < w && slot[x] != 0;
      const unsigned int mask = __ballot_sync(0xffffffffu, used);
      if (used) {
        const int j = count + __popc(mask & ((1u << tid) - 1u));
        slot[x] = j;
        cols[j] = x * c;  // the column's offset in elements within a feature row
      }
      count += __popc(mask);
    }
    if (tid == 0) n_cols = count;
  }
  __syncthreads();
  // an x-tap names its column's place in the list from here on
  for (int k = tid; k < p * taps; k += nthr) {
    const int idx = xtab[k].idx;
    if (idx >= 0) xtab[k].idx = slot[idx];
  }
  __syncthreads();

  // Both passes walk their (column or bin, vector) pairs `nthr` at a time: a
  // thread's first pair, and how a step of nthr pairs moves it (no division
  // in the loops).  Offsets within an image fit an int (h * w * c < 2^31).
  const int items = n_cols * vpc;  // (column, vector) pairs of pass 1
  const int first_j = tid / vpc;
  const int first_v = tid - first_j * vpc;
  const int step_j = nthr / vpc;
  const int step_v = nthr - step_j * vpc;
  auto advance = [&](int& j, int& v) {
    j += step_j;
    v += step_v;
    if (v >= vpc) {
      v -= vpc;
      ++j;
    }
  };
  const T* img = feat + (size_t)b * h * w * c + c0;
  const int row = w * c;
  for (int ph = 0; ph < p; ++ph) {
    const Tap* ye = ytab + (size_t)ph * taps;
    T* dst = out + ((size_t)bn * p + ph) * p * c + c0;
    if (ye[0].idx < 0) {  // every y-sample of the row lies outside: zeros
      float zero[V];
#pragma unroll
      for (int u = 0; u < V; ++u) zero[u] = 0.f;
      for (int i = tid, pw = first_j, v = first_v; i < p * vpc; i += nthr, advance(pw, v)) {
        Vec<T, V>::store(dst + (size_t)pw * c + v * V, zero);
      }
      continue;
    }

    // pass 1: T[j, c] = sum over the row's y-taps of Wy * F[y, cols[j], c]
    if constexpr (kS > 0) {
      constexpr int kTaps = kS > 0 ? 2 * kS : 1;
      float wy[kTaps];
      int off[kTaps];
      bool on[kTaps];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const Tap tap = ye[t];
        on[t] = tap.idx >= 0;
        wy[t] = tap.w;
        off[t] = max(tap.idx, 0) * row;
      }
      // two columns a turn: up to 4s loads of a thread in flight together
      for (int i0 = tid, j0 = first_j, v0 = first_v; i0 < items; i0 += 2 * nthr) {
        const bool two = i0 + nthr < items;
        int j1 = j0, v1 = v0;
        if (two) advance(j1, v1);
        const T* src0 = img + (cols[j0] + v0 * V);
        const T* src1 = img + (cols[j1] + v1 * V);
        typename Vec<T, V>::Raw raw0[kTaps], raw1[kTaps];
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          if (on[t]) {
            raw0[t] = Vec<T, V>::load(src0 + off[t]);
            if (two) raw1[t] = Vec<T, V>::load(src1 + off[t]);
          }
        }
        float acc[V];
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = 0.f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          if (on[t]) Vec<T, V>::fma(wy[t], raw0[t], acc);
        }
        tile_store<V>(tile, j0, v0, vpc, acc);
        if (two) {
#pragma unroll
          for (int u = 0; u < V; ++u) acc[u] = 0.f;
#pragma unroll
          for (int t = 0; t < kTaps; ++t) {
            if (on[t]) Vec<T, V>::fma(wy[t], raw1[t], acc);
          }
          tile_store<V>(tile, j1, v1, vpc, acc);
        }
        j0 = j1;
        v0 = v1;
        advance(j0, v0);
      }
    } else {
      for (int i = tid, j = first_j, v = first_v; i < items; i += nthr, advance(j, v)) {
        const T* src = img + (cols[j] + v * V);
        float acc[V];
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = 0.f;
        for (int t = 0; t < taps; ++t) {
          const Tap tap = ye[t];
          if (tap.idx < 0) break;
          Vec<T, V>::fma(tap.w, Vec<T, V>::load(src + tap.idx * row), acc);
        }
        tile_store<V>(tile, j, v, vpc, acc);
      }
    }
    __syncthreads();

    // pass 2: out[ph, pw, c] = sum over the bin's x-taps of Wx * T[slot, c]
    for (int i = tid, pw = first_j, v = first_v; i < p * vpc; i += nthr, advance(pw, v)) {
      const Tap* e = xtab + pw * taps;
      float acc[V];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = 0.f;
      if constexpr (kS > 0) {
#pragma unroll
        for (int t = 0; t < 2 * kS; ++t) {
          const Tap tap = e[t];
          if (tap.idx >= 0) tile_fma<V>(tile, tap.idx, v, vpc, tap.w, acc);
        }
      } else {
        for (int t = 0; t < taps; ++t) {
          const Tap tap = e[t];
          if (tap.idx < 0) break;
          tile_fma<V>(tile, tap.idx, v, vpc, tap.w, acc);
        }
      }
      Vec<T, V>::store(dst + (size_t)pw * c + v * V, acc);
    }
    __syncthreads();  // the sums of this row are read: the next row may overwrite them
  }
}

template <typename T, int V, int kS>
int launch_kernel(const void* feat, const float* rois, void* out, int b, int n, int h, int w,
                  int c, int p, int s, float scale, int slice, int threads, cudaStream_t st) {
  const size_t smem = smem_bytes(w, p, s, slice);
  if (smem > (size_t)kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(roi_align_fwd_kernel<T, V, kS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((unsigned int)((size_t)b * n), (unsigned int)((c + slice - 1) / slice));
  roi_align_fwd_kernel<T, V, kS><<<grid, threads, smem, st>>>(
      static_cast<const T*>(feat), rois, static_cast<T*>(out), n, h, w, c, p, s, scale, slice,
      w < 2 * s * p ? w : 2 * s * p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_vec(const void* feat, const float* rois, void* out, int b, int n, int h, int w, int c,
               int p, int s, float scale, int slice, int threads, cudaStream_t st) {
  return s == 2 ? launch_kernel<T, V, 2>(feat, rois, out, b, n, h, w, c, p, s, scale, slice,
                                         threads, st)
                : launch_kernel<T, V, 0>(feat, rois, out, b, n, h, w, c, p, s, scale, slice,
                                         threads, st);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block needs at this shape and slice (at
// most 232448 on sm_90: the wrapper shrinks the slice until it fits).
long long roi_align_fwd_smem_bytes(int w, int p, int s, int slice) {
  return static_cast<long long>(smem_bytes(w, p, s, slice));
}

// dtype: 0 = float32, 1 = bfloat16.  vec = channels a thread loads at once: 16
// bytes' worth (4 f32, 8 bf16) where c is a multiple of it and the feature and
// output pointers are 16-byte aligned, else 2 (c even, pointers aligned to two
// elements); slice = channels a block (a multiple of 8), threads = threads a
// block (a multiple of 32, at most 256); b * n < 2^31, ceil(c / slice) < 65536
// and h * w * c < 2^31 (the wrapper checks all of these).  Returns cudaGetLastError().
int roi_align_fwd_launch(const void* feat, int dtype, const float* rois, void* out, int b, int n,
                         int h, int w, int c, int p, int s, float scale, int vec, int slice,
                         int threads, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (h < 1 || w < 1 || c < 1 || (long long)h * w * c > 2147483647LL || p < 1 || s < 1 ||
      slice < 8 || slice % 8 != 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (vec != 2 && vec != 4 && vec != 8) || c % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    return launch_vec<float, 4>(feat, rois, out, b, n, h, w, c, p, s, scale, slice, threads, st);
  }
  if (dtype == 0 && vec == 2) {
    return launch_vec<float, 2>(feat, rois, out, b, n, h, w, c, p, s, scale, slice, threads, st);
  }
  if (dtype == 1 && vec == 8) {
    return launch_vec<__nv_bfloat16, 8>(feat, rois, out, b, n, h, w, c, p, s, scale, slice,
                                        threads, st);
  }
  if (dtype == 1 && vec == 2) {
    return launch_vec<__nv_bfloat16, 2>(feat, rois, out, b, n, h, w, c, p, s, scale, slice,
                                        threads, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
