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
// What bounds it on the card: the bytes of g (411 MB for one train-step
// stream of the flagship, g = [2, 512, 14, 14, 1024] bf16; 0.128 ms at the
// HBM rate), and a scatter whose targets collide: many ROIs overlap every
// feature cell, and on the train path many ROIs pile onto a few rows
// (clustered proposals, boxes clipped flat against the image border).  A
// scatter sample by sample does 16 dependent accumulator updates per element
// of g and reads g once per y-sample; the accumulator, not the memory, then
// sets the time.  What is left after this design: a warp's walk over its
// list is a chain (list entry, taps, loads of g, updates), the shared memory
// of the sums caps an SM at eight or nine such chains, and g is read ~2.7
// times (a bin touches two or three rows) in 128-byte pieces.
//
// The design is "owner computes" (no atomics: a warp owns one feature row
// and a slice of channels, each lane its own channels of it) in the
// separable form of the sum.  A sample's weight on a cell is a y-factor times
// an x-factor, and a sample outside on either axis weighs 0 on that axis, so
// for one ROI
//     dF[y, x, c] += sum_pw Wx[pw, x] * (sum_ph Wy[ph, y] * g[ph, pw, c])
// with Wy[ph, y] the summed weight of bin ph's s y-samples on row y, times
// 1/s, and Wx likewise.  Four kernels, one stream, no host synchronisation:
//   1. roi_align_bwd_tables: one thread per (ROI, axis, bin) merges the bin's
//      2s corner weights into at most 2s taps (index, weight), duplicates
//      summed, unused taps marked with index -1: ytab, xtab [B, N, P, 2s];
//   2. roi_align_bwd_lists: one warp per (image, row) walks the ROIs 32 at a
//      time and writes, at the ballot's prefix count, the indices of those
//      whose row support holds the row: lists [B, H, N] in ROI order and their
//      lengths [B, H].  The support runs from the low corner of the first
//      y-sample to the high corner of the last (a superset: the tables decide
//      the weights); a ROI wholly beyond one border has none;
//   3. roi_align_bwd_rows: a warp takes a segment of one row's list and a
//      slice of 64 channels, with that row's [W, 64] f32 sum in shared memory.
//      For every ROI of the segment (each one a hit) the lanes look up the
//      bins' y-taps on this row, a ballot names the bins ph with one, the warp
//      forms t[pw] = sum_ph Wy * g[ph, pw] in registers (the loads of up to
//      four bin rows, P each, 128 B a warp in bf16, are in flight together)
//      and scatters t through the x-taps once, the taps of a bin read, added
//      and written together: ~2.5 updates a bin instead of 4 per y-sample.
//      The walk is pipelined by hand: while the warp scatters ROI i, the bin
//      rows of ROI i + 1 are on their way from memory and the taps of ROI
//      i + 2 arrive in shared memory (cp.async).  A row's list of L entries is
//      cut into ceil(L / seg) segments of equal length, so the work per warp
//      is bounded whatever the ROI layout.  A row with one segment is written
//      to dF directly, the others to an f32 scratch [ceil(N / seg), B, H, W,
//      C], of which only those rows are touched;
//   4. roi_align_bwd_sum: sums the partial rows of a row with several
//      segments in segment order, writes zeros for a row with an empty list.
// The order of every sum is fixed by the ROI order and the list lengths, so
// the result is bit-identical from launch to launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSlice = 2 * kWarp;  // channels per warp, two per lane

// One merged corner of a bin along an axis: row or column (-1: unused), weight.
struct __align__(8) Tap {
  int idx;
  float w;
};

// The two channels of one lane: loaded as they lie in memory (Raw, so that
// loads in flight cost few registers), widened to f32, and stored.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  typedef float2 Raw;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static float2 widen(Raw r) { return r; }
  __device__ static void store(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
};

template <>
struct Pair<__nv_bfloat16> {
  typedef __nv_bfloat162 Raw;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ static float2 widen(Raw r) { return __bfloat1622float2(r); }
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

// A ROI side in feature coordinates: its start and its bin size.
__device__ __forceinline__ void roi_side(const float* roi, int axis, float scale, int p,
                                         float* start, float* bin) {
  const float a = __fsub_rn(__fmul_rn(roi[axis], scale), 0.5f);
  const float z = __fsub_rn(__fmul_rn(roi[axis + 2], scale), 0.5f);
  *start = a;
  *bin = __fdiv_rn(__fsub_rn(z, a), (float)p);
}

// Kernel 1: the taps of bin `bin` of one ROI side (axis 0: x, 1: y).
__global__ void roi_align_bwd_tables(const float* __restrict__ rois, Tap* __restrict__ ytab,
                                     Tap* __restrict__ xtab, int total_rois, int h, int w,
                                     int p, int s, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_rois * 2 * p) return;
  const int bin = i % p;
  const int axis = (i / p) % 2;
  const int r = i / (2 * p);
  const int size = axis ? h : w;
  const int taps = 2 * s;
  Tap* e = (axis ? ytab : xtab) + ((size_t)r * p + bin) * taps;
  float start, side;
  roi_side(rois + (size_t)r * 4, axis, scale, p, &start, &side);
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
  for (; cnt < taps; ++cnt) {
    e[cnt].idx = -1;
    e[cnt].w = 0.f;
  }
}

// Whether samples a (the first) and z (the last) both lie beyond one border.
__device__ __forceinline__ bool beyond(float a, float z, int size) {
  return (a > (float)size && z > (float)size) || (a < -1.f && z < -1.f);
}

// Kernel 2: one warp per (image, row): the ROIs whose support holds the row.
__global__ void roi_align_bwd_lists(const float* __restrict__ rois, int* __restrict__ lists,
                                    int* __restrict__ lens, int bsz, int n_rois, int h, int w,
                                    int p, int s, float scale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;  // b * h + y
  if (row >= bsz * h) return;
  const int lane = threadIdx.x % kWarp;
  const int b = row / h;
  const int y = row % h;
  int* list = lists + (size_t)row * n_rois;
  int count = 0;
  for (int n0 = 0; n0 < n_rois; n0 += kWarp) {
    const int n = n0 + lane;
    bool hit = false;
    if (n < n_rois) {
      const float* roi = rois + ((size_t)b * n_rois + n) * 4;
      float left, bin_w, top, bin_h;
      roi_side(roi, 0, scale, p, &left, &bin_w);
      roi_side(roi, 1, scale, p, &top, &bin_h);
      const float ya = sample_pos(top, bin_h, 0, s);
      const float yz = sample_pos(top, bin_h, p * s - 1, s);
      const float xa = sample_pos(left, bin_w, 0, s);
      const float xz = sample_pos(left, bin_w, p * s - 1, s);
      const Sample sa = make_sample(ya, h);
      const Sample sz = make_sample(yz, h);
      hit = !beyond(ya, yz, h) && !beyond(xa, xz, w) && min(sa.lo, sz.lo) <= y &&
            y <= max(sa.hi, sz.hi);
    }
    const unsigned int mask = __ballot_sync(0xffffffffu, hit);
    if (hit) list[count + __popc(mask & ((1u << lane) - 1u))] = n;
    count += __popc(mask);
  }
  if (lane == 0) lens[row] = count;
}

// The segment `sg` of a list of `len` entries cut into ceil(len / seg) equal
// parts: [first, last).  Returns the number of parts (0 for an empty list).
__device__ __forceinline__ int segment(int len, int seg, int sg, int* first, int* last) {
  const int nseg = (len + seg - 1) / seg;
  if (nseg == 0) return 0;
  const int per = (len + nseg - 1) / nseg;
  *first = min(len, sg * per);
  *last = min(len, *first + per);
  return nseg;
}

// Copies `bytes` (a multiple of 16, both pointers 16-byte aligned) from global
// to shared memory behind the warp's back (cp.async), as part of the group
// that the next stage_commit() closes.
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes, int lane) {
  const unsigned int to = (unsigned int)__cvta_generic_to_shared(dst);
  const char* from = static_cast<const char*>(src);
  for (int at = lane * 16; at < bytes; at += kWarp * 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(to + at), "l"(from + at));
  }
}

__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;"); }

// Waits until all groups but the newest have arrived, for every lane.
__device__ __forceinline__ void stage_wait_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncwarp();
}

// The bin rows of g one ROI puts on a feature row, as kernel 3 carries them
// from one step of its walk to the next: which bins (a ballot over lanes =
// bins), each lane's weight, and the first kHits rows' loads in flight.
template <typename T, int kP, int kHits>
struct Hits {
  unsigned int rest;  // bins with a tap on the row, not yet loaded
  float wy;           // this lane's bin's weight on the row
  int src[kHits];     // the bins whose rows are in `raw` (-1: none)
  typename Pair<T>::Raw raw[kHits][kP];
};

// Kernel 3.  Grid: x = groups of blockDim.x / 32 channel slices (one warp
// each, on their own but started together: neighbouring bytes of g are read
// at about the same time), y = feature row, z = segment * B + image.  kP =
// the most bins a side it holds in registers (p <= kP <= 32); kS = the
// sampling ratio when it is known at compile time (a bin's taps then update
// the sums together), 0 for any other.  Shared memory per warp: the row's
// sums [w][64] f32, then three buffers of one ROI's taps [3][2][p][2s] (y,
// x).  The walk is pipelined by hand, because its steps are one chain of
// latencies: while the warp scatters ROI i, the first bin rows of ROI i + 1
// are on their way from memory and the taps of ROI i + 2 are being staged.
template <typename T, int kS, int kP>
__global__ void roi_align_bwd_rows(const T* __restrict__ g, const Tap* __restrict__ ytab,
                                   const Tap* __restrict__ xtab, const int* __restrict__ lists,
                                   const int* __restrict__ lens, T* __restrict__ out,
                                   float* __restrict__ part, int bsz, int n_rois, int h, int w,
                                   int c, int p, int s, int seg) {
  extern __shared__ __align__(16) float smem[];
  // bin rows of g in flight together: 64 registers' worth of loads
  constexpr int kHits = 64 / (kP * ((int)sizeof(typename Pair<T>::Raw) / 4));
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int slice = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (slice * kSlice >= c) return;
  const int c0 = slice * kSlice + 2 * lane;
  const bool active = c0 < c;  // c is even: both of a lane's channels, or none
  const int y = blockIdx.y;
  const int b = blockIdx.z % bsz;
  const int sg = blockIdx.z / bsz;
  int first, last;
  const int nseg = segment(lens[b * h + y], seg, sg, &first, &last);
  if (sg >= nseg) return;

  const int taps = kS ? 2 * kS : 2 * s;
  const int roi_taps = p * taps;  // of one axis of one ROI
  float* mine = smem + (size_t)warp * (w * kSlice + 12 * roi_taps);
  float2* acc = reinterpret_cast<float2*>(mine) + lane;  // [w][kWarp] pairs, this lane's
  Tap* staged = reinterpret_cast<Tap*>(mine + w * kSlice);  // [3][2][roi_taps]
  for (int x = 0; x < w; ++x) acc[x * kWarp] = make_float2(0.f, 0.f);

  const int* list = lists + ((size_t)b * h + y) * n_rois;
  const size_t roi0 = (size_t)b * n_rois;
  const T* g_img = g + roi0 * p * p * c + c0;

  // the taps of list entry i into buffer i % 3 (an empty group past the end)
  auto stage_entry = [&](int i) {
    if (i < last) {
      const size_t r = (roi0 + list[i]) * roi_taps;
      Tap* to = staged + ((i - first) % 3) * 2 * roi_taps;
      stage(to, ytab + r, roi_taps * (int)sizeof(Tap), lane);
      stage(to + roi_taps, xtab + r, roi_taps * (int)sizeof(Tap), lane);
    }
    stage_commit();
  };
  // loads up to kHits of the bin rows of ROI n that `hits.rest` names
  auto load_rows = [&](Hits<T, kP, kHits>& hits, int n) {
#pragma unroll
    for (int d = 0; d < kHits; ++d) {
      hits.src[d] = hits.rest != 0u ? __ffs(hits.rest) - 1 : -1;
      hits.rest &= hits.rest - 1u;
      if (hits.src[d] < 0 || !active) continue;
      const T* g_row = g_img + ((size_t)n * p + hits.src[d]) * p * c;
#pragma unroll
      for (int pw = 0; pw < kP; ++pw) {
        if (pw < p) hits.raw[d][pw] = Pair<T>::load(g_row + (size_t)pw * c);
      }
    }
  };
  // entry i's taps are staged: its bins on row y, and its first loads
  auto begin_entry = [&](Hits<T, kP, kHits>& hits, int i) {
    const Tap* ye = staged + ((i - first) % 3) * 2 * roi_taps;
    hits.wy = 0.f;
    bool hit = false;
    if (lane < p) {  // lane l sums the taps of bin l that lie on row y
#pragma unroll
      for (int j = 0; j < taps; ++j) {
        const Tap tap = ye[lane * taps + j];
        if (tap.idx == y) {
          hits.wy += tap.w;
          hit = true;
        }
      }
    }
    hits.rest = __ballot_sync(0xffffffffu, hit);
    load_rows(hits, list[i]);
  };

  Hits<T, kP, kHits> hits;
  stage_entry(first);
  stage_entry(first + 1);
  stage_wait_but_one();
  begin_entry(hits, first);
  for (int i = first; i < last; ++i) {
    // t[pw] = sum over the bins ph on this row of Wy[ph] * g[ph, pw]
    const int n = list[i];
    const bool any = hits.src[0] >= 0;
    float2 t[kP];
#pragma unroll
    for (int pw = 0; pw < kP; ++pw) t[pw] = make_float2(0.f, 0.f);
    while (true) {
#pragma unroll
      for (int d = 0; d < kHits; ++d) {
        const float wyp = __shfl_sync(0xffffffffu, hits.wy, max(hits.src[d], 0));
        if (hits.src[d] < 0 || !active) continue;
#pragma unroll
        for (int pw = 0; pw < kP; ++pw) {
          if (pw < p) {
            const float2 gv = Pair<T>::widen(hits.raw[d][pw]);
            t[pw].x = fmaf(wyp, gv.x, t[pw].x);
            t[pw].y = fmaf(wyp, gv.y, t[pw].y);
          }
        }
      }
      if (hits.rest == 0u) break;
      load_rows(hits, n);  // a ROI with more than kHits bins on this row
    }
    // every lane is done with entry i - 1: its buffer takes entry i + 2; then
    // entry i + 1, whose taps have arrived, starts its loads
    __syncwarp();
    stage_entry(i + 2);
    stage_wait_but_one();
    const Tap* xe = staged + ((i - first) % 3) * 2 * roi_taps + roi_taps;
    if (i + 1 < last) begin_entry(hits, i + 1);
    if (!any || !active) continue;
    // dF[y, x] += sum over pw of Wx[pw, x] * t[pw]
#pragma unroll
    for (int pw = 0; pw < kP; ++pw) {
      if (pw >= p) break;
      const Tap* e = xe + pw * taps;
      if (kS) {
        // the taps of one bin lie on different columns: read, add, write together
        Tap tap[kS ? 2 * kS : 1];
        float2 v[kS ? 2 * kS : 1];
#pragma unroll
        for (int j = 0; j < 2 * kS; ++j) {
          tap[j] = e[j];
          if (tap[j].idx >= 0) v[j] = acc[tap[j].idx * kWarp];
        }
#pragma unroll
        for (int j = 0; j < 2 * kS; ++j) {
          if (tap[j].idx >= 0) {
            acc[tap[j].idx * kWarp] = make_float2(fmaf(tap[j].w, t[pw].x, v[j].x),
                                                  fmaf(tap[j].w, t[pw].y, v[j].y));
          }
        }
      } else {
        for (int j = 0; j < taps; ++j) {
          const Tap tap = e[j];
          if (tap.idx < 0) break;
          float2 v = acc[tap.idx * kWarp];
          v.x = fmaf(tap.w, t[pw].x, v.x);
          v.y = fmaf(tap.w, t[pw].y, v.y);
          acc[tap.idx * kWarp] = v;
        }
      }
    }
  }

  if (!active) return;
  if (nseg == 1) {
    T* dst = out + (((size_t)b * h + y) * w) * c + c0;
    for (int x = 0; x < w; ++x) Pair<T>::store(dst + (size_t)x * c, acc[x * kWarp]);
  } else {
    float* dst = part + ((((size_t)sg * bsz + b) * h + y) * w) * c + c0;
    for (int x = 0; x < w; ++x) Pair<float>::store(dst + (size_t)x * c, acc[x * kWarp]);
  }
}

// Kernel 4.  Grid: x = parts of a row, y = image * H + row.  A row with one
// segment was written by kernel 3; one with none gets zeros; the others the
// sum of their partial rows in segment order.  `rows` = B * H.
template <typename T>
__global__ void roi_align_bwd_sum(const float* __restrict__ part, const int* __restrict__ lens,
                                  T* __restrict__ out, int rows, int row_pairs, int seg) {
  const int row = blockIdx.y;
  const int len = lens[row];
  const int nseg = (len + seg - 1) / seg;
  if (nseg == 1) return;
  const float2* src = reinterpret_cast<const float2*>(part) + (size_t)row * row_pairs;
  T* dst = out + (size_t)row * row_pairs * 2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < row_pairs;
       i += gridDim.x * blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    for (int r = 0; r < nseg; ++r) {
      const float2 a = src[(size_t)r * rows * row_pairs + i];
      v.x += a.x;
      v.y += a.y;
    }
    Pair<T>::store(dst + 2 * (size_t)i, v);
  }
}

struct Work {  // the workspace: tables, lists, lengths
  Tap* ytab;
  Tap* xtab;
  int* lists;
  int* lens;
};

size_t table_taps(int b, int n, int p, int s) { return (size_t)b * n * p * 2 * s; }

Work carve(void* base, int b, int n, int h, int p, int s) {
  Work wk;
  wk.ytab = static_cast<Tap*>(base);
  wk.xtab = wk.ytab + table_taps(b, n, p, s);
  wk.lists = reinterpret_cast<int*>(wk.xtab + table_taps(b, n, p, s));
  wk.lens = wk.lists + (size_t)b * h * n;
  return wk;
}

int launch_lists(const float* rois, int* lists, int* lens, int b, int n, int h, int w, int p,
                 int s, float scale, cudaStream_t st) {
  const int warps = 4;
  roi_align_bwd_lists<<<(unsigned int)((b * h + warps - 1) / warps), warps * kWarp, 0, st>>>(
      rois, lists, lens, b, n, h, w, p, s, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kS, int kP>
int launch_rows(const T* g, const Work& wk, T* out, float* part, int b, int n, int h, int w,
                int c, int p, int s, int seg, int warps, cudaStream_t st) {
  // per warp: the row's sums, and three buffers of one ROI's y and x taps
  const size_t smem =
      (size_t)warps * ((size_t)w * kSlice + 12 * (size_t)p * 2 * s) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd_rows<T, kS, kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int slices = (c + kSlice - 1) / kSlice;
  const int nseg = (n + seg - 1) / seg;
  const dim3 grid((unsigned int)((slices + warps - 1) / warps), (unsigned int)h,
                  (unsigned int)(nseg * b));
  roi_align_bwd_rows<T, kS, kP><<<grid, warps * kWarp, smem, st>>>(
      g, wk.ytab, wk.xtab, wk.lists, wk.lens, out, part, b, n, h, w, c, p, s, seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* g, const float* rois, void* out, float* part, void* work, int b, int n,
           int h, int w, int c, int p, int s, float scale, int seg, int warps,
           cudaStream_t st) {
  const Work wk = carve(work, b, n, h, p, s);
  const int threads = 128;
  const int bins = b * n * 2 * p;
  roi_align_bwd_tables<<<(bins + threads - 1) / threads, threads, 0, st>>>(
      rois, wk.ytab, wk.xtab, b * n, h, w, p, s, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int rc = launch_lists(rois, wk.lists, wk.lens, b, n, h, w, p, s, scale, st);
  if (rc != 0) return rc;
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (p <= 16) {
    rc = s == 2 ? launch_rows<T, 2, 16>(gt, wk, ot, part, b, n, h, w, c, p, s, seg, warps, st)
                : launch_rows<T, 0, 16>(gt, wk, ot, part, b, n, h, w, c, p, s, seg, warps, st);
  } else {
    rc = s == 2 ? launch_rows<T, 2, 32>(gt, wk, ot, part, b, n, h, w, c, p, s, seg, warps, st)
                : launch_rows<T, 0, 32>(gt, wk, ot, part, b, n, h, w, c, p, s, seg, warps, st);
  }
  if (rc != 0) return rc;
  const int row_pairs = w * c / 2;
  const int parts = row_pairs < 8 * 1024 ? (row_pairs + 1023) / 1024 : 8;
  const dim3 grid((unsigned int)parts, (unsigned int)(b * h));
  roi_align_bwd_sum<T><<<grid, 256, 0, st>>>(part, wk.lens, ot, b * h, row_pairs, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the workspace the launch needs beside the f32 scratch: the taps
// [2, B, N, P, 2s] of 8 bytes, the row lists [B, H, N] and lengths [B, H].
long long roi_align_bwd_work_bytes(int b, int n, int h, int p, int s) {
  const size_t rows = (size_t)b * h;
  return static_cast<long long>(2 * table_taps(b, n, p, s) * sizeof(Tap) +
                                (rows * n + rows) * sizeof(int));
}

// The row lists alone (kernel 2): lists [B, H, N] int32, filled from the
// front in ROI order (the rest is not written), lens [B, H] int32.
int roi_align_bwd_lists_launch(const float* rois, int* lists, int* lens, int b, int n, int h,
                               int w, int p, int s, float scale, void* stream) {
  if (b <= 0 || h <= 0) return 0;
  return launch_lists(rois, lists, lens, b, n, h, w, p, s, scale,
                      static_cast<cudaStream_t>(stream));
}

// dtype (of g and of the output): 0 = float32, 1 = bfloat16.  c must be even,
// 1 <= p <= 32, n >= 1 and g, out and rois aligned to two of their elements;
// `part` is the f32 scratch [ceil(n / seg), b, h, w, c] (unused, and may be
// null, when seg >= n), `work` the workspace of roi_align_bwd_work_bytes; a
// block is `warps` warps, each with its own slice of 64 channels of one
// feature row, and their sums share its shared memory (the wrapper checks the
// size).  Returns cudaGetLastError().
int roi_align_bwd_launch(const void* g, int dtype, const float* rois, void* out, void* part,
                         void* work, int b, int n, int h, int w, int c, int p, int s,
                         float scale, int seg, int warps, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (seg < 1 || warps < 1 || p < 1 || p > 32 || s < 1 || c % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(part);
  if (dtype == 0) {
    return launch<float>(g, rois, out, scratch, work, b, n, h, w, c, p, s, scale, seg, warps,
                         st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(g, rois, out, scratch, work, b, n, h, w, c, p, s, scale, seg,
                                 warps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
