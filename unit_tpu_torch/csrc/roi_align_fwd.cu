// ROIAlignV2 forward (aligned=True) for Hopper (sm_90a).
//
// Replaces: unit_tpu/ops/roi_align_pallas.py::roi_align_pallas_batched
// (`_forward`, kernels `_kernel_vmem` and `_kernel`).  Semantics are those of
// unit_tpu/ops/roi_align.py:29-95: ROI corners are scaled and shifted by
// -0.5, every output bin averages s x s bilinear samples, a sample with
// y < -1, y > H, x < -1 or x > W contributes zero, coordinates are clamped to
// [0, H-1] x [0, W-1] and y1 = min(y0 + 1, H - 1) (the Pallas kernel's
// "clamp y0 to H-2 and set ly = 1" is the same for every H >= 2).
// Features [B, H, W, C] channels-last (f32 or bf16), ROIs [B, N, 4] f32 ->
// pooled [B, N, P, P, C] in the feature dtype.
//
// What bounds it on the card: no matmul, only gathers.  Each bin reads
// s*s*4 channel rows of the feature map (a [50, 84, 1024] bf16 map is 8.6 MB
// and stays in the 50 MB L2) and writes one; the pooled output of the
// flagship (1000 x 14 x 14 x 1024 bf16, 400 MB) is the only DRAM-sized
// stream.  So the design keeps every access coalesced and writes each output
// element once:
//   * one block per (image, ROI, output row ph), threads across channels, two
//     neighbouring channels per thread (float2 / __nv_bfloat162 loads), so a
//     warp reads 128-256 contiguous bytes of one feature row per corner;
//   * the per-sample coordinates and weights are computed once per block into
//     shared memory and read as broadcasts;
//   * samples accumulate in f32 registers and are stored once, times 1/s^2,
//     in the feature dtype.  The TPU kernel `_kernel_vmem` rounds its staged
//     y-interpolated rows to the feature dtype before its x-matmul; this
//     kernel keeps f32 to the end, as unit_tpu's XLA path does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int n_rois, int h,
                                     int w, int c, int p, int s, float scale) {
  extern __shared__ Sample samples[];  // [p*s] along x, then [s] along y
  Sample* xs = samples;
  Sample* ys = samples + p * s;

  const int ph = blockIdx.x % p;
  const int bn = blockIdx.x / p;  // b * n_rois + n
  const int b = bn / n_rois;
  const float* roi = rois + (size_t)bn * 4;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), 0.5f);
  const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)p);
  const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)p);

  for (int k = threadIdx.x; k < p * s + s; k += blockDim.x) {
    if (k < p * s) {
      xs[k] = make_sample(sample_pos(x1, bin_w, k, s), w);
    } else {
      ys[k - p * s] = make_sample(sample_pos(y1, bin_h, ph * s + (k - p * s), s), h);
    }
  }
  __syncthreads();

  const T* img = feat + (size_t)b * h * w * c;
  T* dst = out + ((size_t)bn * p + ph) * p * c;
  const float inv = __fdiv_rn(1.f, (float)(s * s));
  for (int c2 = 2 * threadIdx.x; c2 < c; c2 += 2 * blockDim.x) {
    for (int pw = 0; pw < p; ++pw) {
      float acc_x = 0.f;
      float acc_y = 0.f;
      for (int iy = 0; iy < s; ++iy) {
        const Sample sy = ys[iy];
        const T* row_lo = img + (size_t)sy.lo * w * c + c2;
        const T* row_hi = img + (size_t)sy.hi * w * c + c2;
        for (int ix = 0; ix < s; ++ix) {
          const Sample sx = xs[pw * s + ix];
          if (sy.oob || sx.oob) continue;
          const float w00 = __fmul_rn(sy.wl, sx.wl);
          const float w01 = __fmul_rn(sy.wl, sx.wh);
          const float w10 = __fmul_rn(sy.wh, sx.wl);
          const float w11 = __fmul_rn(sy.wh, sx.wh);
          const float2 g00 = Pair<T>::load(row_lo + (size_t)sx.lo * c);
          const float2 g01 = Pair<T>::load(row_lo + (size_t)sx.hi * c);
          const float2 g10 = Pair<T>::load(row_hi + (size_t)sx.lo * c);
          const float2 g11 = Pair<T>::load(row_hi + (size_t)sx.hi * c);
          acc_x += g00.x * w00 + g01.x * w01 + g10.x * w10 + g11.x * w11;
          acc_y += g00.y * w00 + g01.y * w01 + g10.y * w10 + g11.y * w11;
        }
      }
      Pair<T>::store(dst + (size_t)pw * c + c2, make_float2(acc_x * inv, acc_y * inv));
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  c must be even and the feature pointer
// 4-byte aligned (the wrapper checks both).  Returns cudaGetLastError().
int roi_align_fwd_launch(const void* feat, int dtype, const float* rois,
                         void* out, int b, int n, int h, int w, int c, int p,
                         int s, float scale, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = c / 2;
  int threads = pairs < 512 ? pairs : 512;
  threads = ((threads + 31) / 32) * 32;
  const size_t smem = (size_t)(p * s + s) * sizeof(Sample);
  const unsigned int blocks = (unsigned int)b * (unsigned int)n * (unsigned int)p;
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<blocks, threads, smem, st>>>(
        static_cast<const float*>(feat), rois, static_cast<float*>(out), n, h, w, c, p, s, scale);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<blocks, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(feat), rois, static_cast<__nv_bfloat16*>(out), n, h, w,
        c, p, s, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
