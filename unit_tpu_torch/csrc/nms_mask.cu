// Exact greedy NMS keep mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces: unit_tpu/ops/nms_pallas.py::nms_sorted_mask_pallas (Pallas
// `_kernel`, IoU in `_pair_iou`); the semantics are those of
// unit_tpu/ops/nms.py::nms_sorted_mask: a box is suppressed iff an earlier
// kept box has IoU > thr (strict), and zero-area boxes are never kept and
// never suppress.  With `max_keep` the walk stops after that many keeps; the
// first `max_keep` keeps are those of full greedy NMS (ops/nms.py:69-81) and
// every later row is reported as not kept.
//
// What bounds it on the card:
//   * phase 1 computes N^2/2 IoUs from boxes that sit in shared memory and
//     writes an upper-triangular bitmask of N * ceil(N/64) * 8 bytes (about
//     50 MB for the 20000 class-offset boxes of the final NMS).  It is bound
//     by that store traffic and by the float division per pair.
//   * phase 2 is inherently sequential: each kept row ORs its mask row into
//     the "removed" set.  It is latency-bound (one global load per kept row
//     and word), so it runs as ONE block with the removed bitset in shared
//     memory; there is no host round trip per row, as torchvision's loop has.
//
// Exactness: a keep decision flips if an IoU lands one ulp on the other side
// of thr, so the IoU is computed with round-to-nearest intrinsics in the op
// order of structures/boxes.py::pairwise_iou, and this file is built with
// -fmad=false so nothing is contracted into an FMA.  The result is then
// bit-identical to the plain PyTorch version (ops/nms.py) and to unit_tpu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kWalkThreads = 512;

__device__ __forceinline__ float area_rn(const float* b) {
  return __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.f),
                   fmaxf(__fsub_rn(b[3], b[1]), 0.f));
}

// pairwise_iou: inter = max(x2-x1, 0) * max(y2-y1, 0) of the intersection,
// union = (area_a + area_b) - inter, IoU 0 where the union is empty.
__device__ __forceinline__ float iou_rn(const float* a, const float* b) {
  const float ix1 = fmaxf(a[0], b[0]);
  const float iy1 = fmaxf(a[1], b[1]);
  const float ix2 = fminf(a[2], b[2]);
  const float iy2 = fminf(a[3], b[3]);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_rn(a), area_rn(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// Phase 1: block (cb, rb) compares the 64 rows of row-tile rb with the 64
// columns of column-tile cb; only tiles on or above the diagonal run, and on
// the diagonal only columns after the row.  mask[i, cb] bit k = row i
// suppresses column cb*64+k.
__global__ void iou_mask_kernel(const float* __restrict__ boxes, int n,
                                float thr, int col_blocks,
                                unsigned long long* __restrict__ mask) {
  const int rb = blockIdx.y;
  const int cb = blockIdx.x;
  if (cb < rb) return;
  __shared__ float cols[kTile * 4];
  const int col_start = cb * kTile;
  const int row_start = rb * kTile;
  const int ncols = min(n - col_start, kTile);
  const int nrows = min(n - row_start, kTile);
  if (threadIdx.x < ncols) {
    const float* src = boxes + (size_t)(col_start + threadIdx.x) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) cols[threadIdx.x * 4 + k] = src[k];
  }
  __syncthreads();
  if (threadIdx.x >= nrows) return;
  const int i = row_start + threadIdx.x;
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = boxes[(size_t)i * 4 + k];
  unsigned long long bits = 0ULL;
  const int j0 = (rb == cb) ? threadIdx.x + 1 : 0;
  for (int j = j0; j < ncols; ++j) {
    if (iou_rn(a, &cols[j * 4]) > thr) bits |= 1ULL << j;
  }
  mask[(size_t)i * col_blocks + cb] = bits;
}

// Phase 2: one block walks the rows in score order.  Thread t owns the words
// wb+1+t, wb+1+t+T, ... of the removed set while row-word wb is walked, so the
// ORs of one kept row never race; a barrier per 64 rows publishes them.
__global__ void greedy_walk_kernel(const float* __restrict__ boxes,
                                   const unsigned long long* __restrict__ mask,
                                   int n, int col_blocks, int max_keep,
                                   bool* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) {
    unsigned long long bits = 0ULL;
    for (int k = 0; k < kTile; ++k) {
      const int r = w * kTile + k;
      if (r >= n) break;
      const float* b = boxes + (size_t)r * 4;
      const bool nonempty = __fsub_rn(b[2], b[0]) > 0.f && __fsub_rn(b[3], b[1]) > 0.f;
      if (!nonempty) bits |= 1ULL << k;  // zero-area rows start removed
    }
    removed[w] = bits;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) keep[r] = false;
  __syncthreads();

  int kept = 0;  // uniform across the block: every thread sees the same rows
  for (int wb = 0; wb < col_blocks && kept < max_keep; ++wb) {
    unsigned long long cur = removed[wb];
    const int lim = min(kTile, n - wb * kTile);
    for (int k = 0; k < lim; ++k) {
      if ((cur >> k) & 1ULL) continue;
      const int row = wb * kTile + k;
      if (threadIdx.x == 0) keep[row] = true;
      const unsigned long long* mrow = mask + (size_t)row * col_blocks;
      cur |= mrow[wb];
      for (int w = wb + 1 + threadIdx.x; w < col_blocks; w += blockDim.x) {
        removed[w] |= mrow[w];
      }
      if (++kept >= max_keep) break;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes [n, 4] f32 sorted by score; mask scratch [n, ceil(n/64)] u64; keep [n]
// bool.  Returns cudaGetLastError() after the launches (0 = success).
int nms_mask_launch(const float* boxes, int n, float thr, int max_keep,
                    unsigned long long* mask, bool* keep, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kTile - 1) / kTile;
  dim3 grid(col_blocks, col_blocks);
  iou_mask_kernel<<<grid, kTile, 0, s>>>(boxes, n, thr, col_blocks, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)col_blocks * sizeof(unsigned long long);
  greedy_walk_kernel<<<1, kWalkThreads, smem, s>>>(
      boxes, mask, n, col_blocks, max_keep, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
