// K4: fused FrozenBN + residual + ReLU epilogue, forward and backward.
//
// Replaces the TPU kernel ep_kernel / ep_pallas of
// scripts/bench_backbone_epilogue.py:145-170:
//     out = relu(float(x) * scale + shift + float(res))   rounded once to x's type
// over a row-major [rows, C] view of an NHWC-dense activation, scale and shift
// f32 [C].  The residual and the ReLU are template flags of the one pass:
// (res, relu) is conv3's epilogue of a bottleneck block, (no res, relu) that
// of conv1, conv2 and the stem, (no res, no relu) that of the shortcut.
//
// Backward (the TPU kernel had none: it was a forward benchmark; here the
// epilogue is on the train path): with the saved output y,
//     dx = g * (y > 0) * scale,   dres = g * (y > 0)
// in one pass; without ReLU the mask is all ones.  scale and shift get no
// gradient: FrozenBN's tensors are buffers.
//
// Bound: bytes.  Every element is read once and written once and takes three
// f32 operations, so the least time is (bytes of x [+ res] + out) / HBM rate:
// 6 bytes an element with a residual and 4 without in bf16.  Design: one
// thread per 16 bytes (8 bf16 or 4 f32) in a grid-stride loop with 64-bit
// indices; a thread's scale and shift come as float4 loads that hit L1 (C * 4
// bytes in all).  When C is not a multiple of the vector width or a pointer is
// not 16-byte aligned, a scalar kernel does the same arithmetic.
//
// Arithmetic: __fmul_rn / __fadd_rn in the order of the plain PyTorch version
// ((x * scale + shift) + res), so nvcc contracts nothing into an FMA and the
// kernel equals ops.bn_act.bn_act_plain bit for bit.  The pass is bound by
// bytes, so the two extra roundings cost no time.
//
// Plain C interface (ctypes); every entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks of 256 threads fill an SM's warps twice

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// 16 bytes of T
template <typename T> struct VecOf { static constexpr int N = 16 / sizeof(T); };
template <typename T> union Pack {
    uint4 v;
    T e[VecOf<T>::N];
    __device__ Pack() {}
};

// NaN stays NaN (as torch.relu keeps it), so a diverged run is still seen.
__device__ __forceinline__ float relu_f(float v) { return v < 0.0f ? 0.0f : v; }

template <bool HAS_RES, bool RELU>
__device__ __forceinline__ float epilogue(float x, float s, float t, float r) {
    float v = __fadd_rn(__fmul_rn(x, s), t);
    if (HAS_RES) v = __fadd_rn(v, r);
    return RELU ? relu_f(v) : v;
}

template <typename T, bool HAS_RES, bool RELU>
__global__ void bn_act_fwd_vec(const T* __restrict__ x, const T* __restrict__ res,
                               const float* __restrict__ scale, const float* __restrict__ shift,
                               T* __restrict__ out, int64_t nvec, int c_vecs) {
    constexpr int N = VecOf<T>::N;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
        const int c0 = (int)(i % c_vecs) * N;
        Pack<T> xv, rv, ov;
        xv.v = reinterpret_cast<const uint4*>(x)[i];
        if (HAS_RES) rv.v = reinterpret_cast<const uint4*>(res)[i];
        float s[N], t[N];
#pragma unroll
        for (int j = 0; j < N; j += 4) {
            const float4 sv = *reinterpret_cast<const float4*>(scale + c0 + j);
            const float4 tv = *reinterpret_cast<const float4*>(shift + c0 + j);
            s[j] = sv.x; s[j + 1] = sv.y; s[j + 2] = sv.z; s[j + 3] = sv.w;
            t[j] = tv.x; t[j + 1] = tv.y; t[j + 2] = tv.z; t[j + 3] = tv.w;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const float r = HAS_RES ? to_f(rv.e[j]) : 0.0f;
            ov.e[j] = from_f<T>(epilogue<HAS_RES, RELU>(to_f(xv.e[j]), s[j], t[j], r));
        }
        reinterpret_cast<uint4*>(out)[i] = ov.v;
    }
}

template <typename T, bool HAS_RES, bool RELU>
__global__ void bn_act_fwd_scalar(const T* __restrict__ x, const T* __restrict__ res,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift, T* __restrict__ out,
                                  int64_t total, int c) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const int ch = (int)(i % c);
        const float r = HAS_RES ? to_f(res[i]) : 0.0f;
        out[i] = from_f<T>(epilogue<HAS_RES, RELU>(to_f(x[i]), scale[ch], shift[ch], r));
    }
}

// dx and dres may each be null (that input needs no gradient).
template <typename T, bool RELU>
__global__ void bn_act_bwd_vec(const T* __restrict__ g, const T* __restrict__ y,
                               const float* __restrict__ scale, T* __restrict__ dx,
                               T* __restrict__ dres, int64_t nvec, int c_vecs) {
    constexpr int N = VecOf<T>::N;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
        const int c0 = (int)(i % c_vecs) * N;
        Pack<T> gv, yv, dxv, drv;
        gv.v = reinterpret_cast<const uint4*>(g)[i];
        if (RELU) yv.v = reinterpret_cast<const uint4*>(y)[i];
        float s[N];
#pragma unroll
        for (int j = 0; j < N; j += 4) {
            const float4 sv = *reinterpret_cast<const float4*>(scale + c0 + j);
            s[j] = sv.x; s[j + 1] = sv.y; s[j + 2] = sv.z; s[j + 3] = sv.w;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
            float gm = to_f(gv.e[j]);
            if (RELU && !(to_f(yv.e[j]) > 0.0f)) gm = 0.0f;  // (y > 0), false for NaN
            drv.e[j] = from_f<T>(gm);
            dxv.e[j] = from_f<T>(__fmul_rn(gm, s[j]));
        }
        if (dx != nullptr) reinterpret_cast<uint4*>(dx)[i] = dxv.v;
        if (dres != nullptr) reinterpret_cast<uint4*>(dres)[i] = drv.v;
    }
}

template <typename T, bool RELU>
__global__ void bn_act_bwd_scalar(const T* __restrict__ g, const T* __restrict__ y,
                                  const float* __restrict__ scale, T* __restrict__ dx,
                                  T* __restrict__ dres, int64_t total, int c) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        float gm = to_f(g[i]);
        if (RELU && !(to_f(y[i]) > 0.0f)) gm = 0.0f;
        if (dx != nullptr) dx[i] = from_f<T>(__fmul_rn(gm, scale[(int)(i % c)]));
        if (dres != nullptr) dres[i] = from_f<T>(gm);
    }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int blocks_for(int64_t work) {
    const int64_t b = (work + kThreads - 1) / kThreads;
    return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T, bool HAS_RES, bool RELU>
void forward_t(const void* x, const void* res, const float* scale, const float* shift,
               void* out, int64_t rows, int c, cudaStream_t stream) {
    constexpr int N = VecOf<T>::N;
    const int64_t total = rows * c;
    const bool vec = c % N == 0 && aligned16(x) && aligned16(out) && aligned16(scale) &&
                     aligned16(shift) && (!HAS_RES || aligned16(res));
    if (vec) {
        const int64_t nvec = total / N;
        bn_act_fwd_vec<T, HAS_RES, RELU><<<blocks_for(nvec), kThreads, 0, stream>>>(
            (const T*)x, (const T*)res, scale, shift, (T*)out, nvec, c / N);
    } else {
        bn_act_fwd_scalar<T, HAS_RES, RELU><<<blocks_for(total), kThreads, 0, stream>>>(
            (const T*)x, (const T*)res, scale, shift, (T*)out, total, c);
    }
}

template <typename T>
void forward_flags(const void* x, const void* res, const float* scale, const float* shift,
                   void* out, int64_t rows, int c, int relu, cudaStream_t stream) {
    if (res != nullptr) {
        if (relu) forward_t<T, true, true>(x, res, scale, shift, out, rows, c, stream);
        else forward_t<T, true, false>(x, res, scale, shift, out, rows, c, stream);
    } else {
        if (relu) forward_t<T, false, true>(x, res, scale, shift, out, rows, c, stream);
        else forward_t<T, false, false>(x, res, scale, shift, out, rows, c, stream);
    }
}

template <typename T, bool RELU>
void backward_t(const void* g, const void* y, const float* scale, void* dx, void* dres,
                int64_t rows, int c, cudaStream_t stream) {
    constexpr int N = VecOf<T>::N;
    const int64_t total = rows * c;
    const bool vec = c % N == 0 && aligned16(g) && aligned16(scale) && (!RELU || aligned16(y)) &&
                     aligned16(dx) && aligned16(dres);  // a null pointer counts as aligned
    if (vec) {
        const int64_t nvec = total / N;
        bn_act_bwd_vec<T, RELU><<<blocks_for(nvec), kThreads, 0, stream>>>(
            (const T*)g, (const T*)y, scale, (T*)dx, (T*)dres, nvec, c / N);
    } else {
        bn_act_bwd_scalar<T, RELU><<<blocks_for(total), kThreads, 0, stream>>>(
            (const T*)g, (const T*)y, scale, (T*)dx, (T*)dres, total, c);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, res and out).  res may be null.
extern "C" int bn_act_fwd_launch(const void* x, const void* res, const float* scale,
                                 const float* shift, void* out, long long rows, int c,
                                 int relu, int dtype, void* stream) {
    if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) forward_flags<float>(x, res, scale, shift, out, rows, c, relu, st);
    else if (dtype == 1) forward_flags<__nv_bfloat16>(x, res, scale, shift, out, rows, c, relu, st);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// y is read only with relu != 0; dx and dres may each be null.
extern "C" int bn_act_bwd_launch(const void* g, const void* y, const float* scale, void* dx,
                                 void* dres, long long rows, int c, int relu, int dtype,
                                 void* stream) {
    if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        if (relu) backward_t<float, true>(g, y, scale, dx, dres, rows, c, st);
        else backward_t<float, false>(g, y, scale, dx, dres, rows, c, st);
    } else if (dtype == 1) {
        if (relu) backward_t<__nv_bfloat16, true>(g, y, scale, dx, dres, rows, c, st);
        else backward_t<__nv_bfloat16, false>(g, y, scale, dx, dres, rows, c, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
