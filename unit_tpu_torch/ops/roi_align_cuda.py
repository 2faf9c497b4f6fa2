"""Wrappers of the ROIAlignV2 kernels: forward K1 (``csrc/roi_align_fwd.cu``)
and backward K2 (``csrc/roi_align_bwd.cu``).

Counterparts of unit_tpu/ops/roi_align_pallas.py::roi_align_pallas_batched
and unit_tpu/ops/roi_align_pallas_bwd.py::roi_align_backward_pallas_batched.
Their plain PyTorch versions are ``ops.roi_align.roi_align_plain`` and
``ops.roi_align.roi_align_backward_plain``; ``ops.roi_align.RoIAlignV2Function``
pairs them for autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


# the arguments both launches begin with: (data, dtype, rois, out)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# K1's blocks keep a row's column sums, and K2's warps their rows' f32 sums, in
# the shared memory of their block: at most 227 KB on sm_90.
_SMEM_LIMIT = 232448
_MAX_GRID_X, _MAX_GRID_Y = 2 ** 31 - 1, 65535
# How K1 cuts its work (chosen on the H100 at the flagship's shapes; PERF.md):
# channels a block (a power of two; the f32 sums of min(W, 2sP) columns of them
# lie in shared memory, so slice and resident blocks trade off) and threads a
# block.  Neither changes a sum.
FWD_TUNING = {"slice": 256, "threads": 256}
FWD_MIN_SLICE = 8
FWD_MAX_THREADS = 256  # the kernel is built for three blocks of up to 256 threads an SM
# How K2 cuts its work (chosen on the H100 at the flagship's shapes; PERF.md):
# "seg" entries of a feature row's list per warp at most (a row with more is
# summed through the f32 scratch), "warps" slices of 64 channels per block.
BWD_TUNING = {"seg": 64, "warps": 4}
# A lane of K2's row walk holds one bin of a ROI's row: output_size <= 32.
MAX_BWD_OUTPUT_SIZE = 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("roi_align_fwd")
    # (data, dtype, rois, out, b, n, h, w, c, p, s, scale, vec, slice, threads, stream)
    lib.roi_align_fwd_launch.argtypes = (
        _ARGTYPES + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.roi_align_fwd_launch.restype = ctypes.c_int
    lib.roi_align_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.roi_align_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("roi_align_bwd")
    # (g, dtype, rois, out, scratch, work, b, n, h, w, c, p, s, scale, seg, warps, stream)
    lib.roi_align_bwd_launch.argtypes = (
        _ARGTYPES + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.roi_align_bwd_launch.restype = ctypes.c_int
    # (rois, lists, lens, b, n, h, w, p, s, scale, stream)
    lib.roi_align_bwd_lists_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.roi_align_bwd_lists_launch.restype = ctypes.c_int
    lib.roi_align_bwd_work_bytes.argtypes = [ctypes.c_int] * 5
    lib.roi_align_bwd_work_bytes.restype = ctypes.c_longlong
    return lib


def fwd_vector(c: int, dtype: torch.dtype, *pointers: int) -> int:
    """Channels a thread of K1 loads at once at this shape: 16 bytes' worth (4
    f32, 8 bf16) where C is a multiple of that and every pointer is 16-byte
    aligned, else 2 (the channel-pair path: C even, pointers aligned to two
    elements), else 0 (K1 does not take the shape).  A pure function of (C,
    dtype, alignment): nothing is tried and caught."""
    size = _ELEMENT_BYTES[dtype]
    wide = 16 // size
    if c % wide == 0 and all(ptr % 16 == 0 for ptr in pointers):
        return wide
    if c % 2 == 0 and all(ptr % (2 * size) == 0 for ptr in pointers):
        return 2
    return 0


def fwd_smem_bytes(w: int, p: int, s: int, channels: int) -> int:
    """Shared memory of one block of K1 with ``channels`` channels a block (as
    ``roi_align_fwd_smem_bytes`` in csrc/roi_align_fwd.cu): the f32 sums
    [min(W, 2sP), channels], the taps [2, P, 2s] of 8 bytes, the column list
    and the columns' slots."""
    cap = min(w, 2 * s * p)
    return cap * channels * 4 + p * 4 * s * 8 + (cap + w) * 4


def fwd_slice(c: int, w: int, p: int, s: int) -> int:
    """Channels a block of K1 at this shape: ``FWD_TUNING["slice"]``, halved
    while half of it still holds all C channels, and halved further (down to
    ``FWD_MIN_SLICE``) while a block's shared memory exceeds the card's limit.
    Raises, naming the limit, where even the smallest slice does not fit."""
    channels = int(FWD_TUNING["slice"])
    while channels > FWD_MIN_SLICE and channels // 2 >= c:
        channels //= 2
    while channels > FWD_MIN_SLICE and fwd_smem_bytes(w, p, s, channels) > _SMEM_LIMIT:
        channels //= 2
    need = fwd_smem_bytes(w, p, s, channels)
    if need > _SMEM_LIMIT:
        raise ValueError(f"W={w}, output_size={p}, sampling_ratio={s} need {need} B of shared "
                         f"memory for {channels} channels of a row's column sums (limit "
                         f"{_SMEM_LIMIT})")
    return channels


def fwd_threads() -> int:
    """Threads a block of K1: ``FWD_TUNING["threads"]``, a multiple of 32 of
    at most ``FWD_MAX_THREADS`` (the kernel's launch bound), else it raises."""
    threads = int(FWD_TUNING["threads"])
    if threads < 32 or threads % 32 or threads > FWD_MAX_THREADS:
        raise ValueError(f"FWD_TUNING['threads'] = {threads}: a block of K1 has a multiple "
                         f"of 32 threads, at most {FWD_MAX_THREADS}")
    return threads


def roi_align_cuda(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """ROIAlignV2 on the card: features [B, H, W, C] (f32 or bf16, contiguous
    channels-last), rois [B, N, 4] f32 -> [B, N, P, P, C] in the feature dtype.

    Counterpart of unit_tpu's roi_align_pallas_batched.  The kernel sums in
    the separable form (``ops.roi_align.roi_align_separable`` is the same sums
    in PyTorch): a block takes one ROI and a slice of channels, merges the
    ROI's bilinear taps once, and for each output row reduces the row's <= 2s
    feature rows along y once per distinct column of the ROI into f32 sums in
    shared memory, then forms each bin from its <= 2s column taps; every
    value stays f32 up to the one rounded store.

    Load paths (``fwd_vector``): 16 bytes a thread (8 bf16 or 4 f32 channels)
    where C is a multiple of that and the feature pointer is 16-byte aligned;
    otherwise two channels a thread, for any even C and a pointer aligned to
    two elements.  Any ``output_size``: a block's shared memory grows with
    min(W, 2 s P) columns times the slice (``FWD_TUNING["slice"]`` channels),
    and the slice is halved until it fits the card's 232448 bytes
    (``fwd_slice``); a shape that does not fit at 8 channels raises and names
    the limit, as does one image's H*W*C of 2^31 or more (32-bit offsets).
    One call queues one device kernel on the current stream, never waits for
    the device, and allocates the output and nothing else.
    There is no other path for a CUDA tensor."""
    if not (features.is_cuda and rois.is_cuda):
        raise ValueError("roi_align_cuda needs CUDA tensors; the plain version "
                         "is ops.roi_align.roi_align_plain")
    if features.device != rois.device:
        raise ValueError(f"features on {features.device}, rois on {rois.device}")
    if features.dtype not in _DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"need [B,H,W,C] and [B,N,4], got {tuple(features.shape)} "
                         f"and {tuple(rois.shape)}")
    b, h, w, c = features.shape
    if rois.shape[0] != b:
        raise ValueError(f"batch {b} of features vs {rois.shape[0]} of rois")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("features and rois must be contiguous ([B,H,W,C] row-major)")
    if output_size < 1 or sampling_ratio < 1:
        raise ValueError("output_size and sampling_ratio must be >= 1")
    n = rois.shape[1]
    p, s = int(output_size), int(sampling_ratio)
    out = torch.empty((b, n, p, p, c), dtype=features.dtype, device=features.device)
    if out.numel() == 0:
        return out
    vec = fwd_vector(c, features.dtype, features.data_ptr(), out.data_ptr())
    if vec == 0:
        raise ValueError(f"the kernel reads channel pairs: C={c} must be even and the "
                         "feature pointer aligned to two elements")
    channels, threads = fwd_slice(c, w, p, s), fwd_threads()
    if h * w * c > _MAX_GRID_X:
        raise ValueError(f"H*W*C = {h * w * c}: the kernel indexes one image's features "
                         f"with 32 bits (limit {_MAX_GRID_X})")
    if b * n > _MAX_GRID_X or -(-c // channels) > _MAX_GRID_Y:
        raise ValueError(f"B*N = {b * n} blocks (limit {_MAX_GRID_X}) of "
                         f"{-(-c // channels)} slices (limit {_MAX_GRID_Y})")
    with torch.cuda.device(features.device):
        rc = _lib().roi_align_fwd_launch(
            features.data_ptr(), _DTYPES[features.dtype], rois.data_ptr(), out.data_ptr(),
            b, n, h, w, c, p, s, float(spatial_scale), vec, channels, threads,
            cuda_lib.stream_handle(features),
        )
    cuda_lib.check(rc, "roi_align_fwd_launch")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def roi_align_backward_cuda(
    g: torch.Tensor,
    rois: torch.Tensor,
    feature_shape,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Gradient of ROIAlignV2 w.r.t. the features on the card: g [B, N, P, P, C]
    (f32 or bf16, contiguous), rois [B, N, 4] f32, feature_shape (B, H, W, C)
    -> dF [B, H, W, C] in the dtype of g, summed in f32, deterministic.

    Counterpart of unit_tpu's roi_align_backward_pallas_batched.  The scatter
    is bound by its accumulator updates, not by the bytes of g, so the kernel
    sums in the separable form (``ops.roi_align.roi_align_backward_separable``
    is the same sums in PyTorch): per ROI and feature row it first reduces g
    over the bins ph in registers and scatters that row once through merged
    column weights; and it visits, per row, only the ROIs that touch it, in
    ROI order, from per-row lists (``ops.roi_align.roi_row_lists`` is their
    plain version) cut into segments of at most ``BWD_TUNING["seg"]`` entries.
    One call queues four device kernels (tables, lists, rows, sum) on the
    current stream and never waits for the device.

    ``output_size`` is at most 32: a lane of the row walk holds one bin of a
    ROI's row, so P > 32 raises and names the limit (K1, the plain versions
    and unit_tpu take any P; every shipped recipe has POOLER_RESOLUTION 6, 14
    or 17).  There is no other path for a CUDA tensor.

    Allocated here: the workspace (taps [2, B, N, P, 2s] of 8 bytes, lists
    [B, H, N] and lengths [B, H] int32) and, when N exceeds the segment, the
    f32 scratch [ceil(N / seg), B, H, W, C], of which only rows with more
    than one segment are written and read.  Their sizes in bytes are left in
    ``roi_align_backward_cuda.scratch_bytes``."""
    if int(output_size) > MAX_BWD_OUTPUT_SIZE:
        raise ValueError(f"output_size {int(output_size)}: the kernel keeps one bin per lane "
                         f"(at most {MAX_BWD_OUTPUT_SIZE})")
    if not (g.is_cuda and rois.is_cuda):
        raise ValueError("roi_align_backward_cuda needs CUDA tensors; the plain "
                         "version is ops.roi_align.roi_align_backward_plain")
    if g.device != rois.device:
        raise ValueError(f"g on {g.device}, rois on {rois.device}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    b, h, w, c = (int(v) for v in feature_shape)
    p, s = int(output_size), int(sampling_ratio)
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[-1] != 4:
        raise ValueError(f"need rois [{b},N,4], got {tuple(rois.shape)}")
    n = rois.shape[1]
    if tuple(g.shape) != (b, n, p, p, c):
        raise ValueError(f"need g {(b, n, p, p, c)}, got {tuple(g.shape)}")
    if not (g.is_contiguous() and rois.is_contiguous()):
        raise ValueError("g and rois must be contiguous")
    if c % 2 or g.data_ptr() % (2 * g.element_size()):
        raise ValueError(f"the kernel reads channel pairs: C={c} must be even and "
                         "the pointer of g aligned to two elements")
    if p < 1 or s < 1 or h < 1 or w < 1:
        raise ValueError("output_size, sampling_ratio, H and W must be >= 1")
    seg, warps = int(BWD_TUNING["seg"]), int(BWD_TUNING["warps"])
    smem = (w * 64 + 12 * p * 2 * s) * 4  # one warp's row of sums, three ROIs' taps
    if smem > _SMEM_LIMIT:
        raise ValueError(f"W={w} needs {smem} B of shared memory for a warp's row "
                         f"of sums (limit {_SMEM_LIMIT})")
    warps = max(1, min(warps, _SMEM_LIMIT // smem))
    if b * n == 0:
        return torch.zeros((b, h, w, c), dtype=g.dtype, device=g.device)
    lib = _bwd_lib()
    out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    work = torch.empty(-(-lib.roi_align_bwd_work_bytes(b, n, h, p, s) // 8), dtype=torch.int64,
                       device=g.device)
    segments = -(-n // seg)
    part = torch.empty((segments if segments > 1 else 0, b, h, w, c), dtype=torch.float32,
                       device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.roi_align_bwd_launch(
            g.data_ptr(), _DTYPES[g.dtype], rois.data_ptr(), out.data_ptr(), part.data_ptr(),
            work.data_ptr(), b, n, h, w, c, p, s, float(spatial_scale), seg, warps,
            cuda_lib.stream_handle(g),
        )
    cuda_lib.check(rc, "roi_align_bwd_launch")
    roi_align_backward_cuda.launches += 1
    roi_align_backward_cuda.scratch_bytes = {
        "scratch": part.numel() * 4, "workspace": work.numel() * 8}
    return out


roi_align_backward_cuda.launches = 0
roi_align_backward_cuda.scratch_bytes = {"scratch": 0, "workspace": 0}


def roi_row_lists_cuda(rois: torch.Tensor, h: int, w: int, output_size: int = 14,
                       spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """K2's list kernel alone, for tests: rois [B, N, 4] f32 on the card ->
    (lists [B, H, N] int32, lengths [B, H] int32) as
    ``ops.roi_align.roi_row_lists`` gives them (ROI order, padded with -1)."""
    if not rois.is_cuda:
        raise ValueError("roi_row_lists_cuda needs a CUDA tensor; the plain "
                         "version is ops.roi_align.roi_row_lists")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"need rois [B,N,4] float32, got {tuple(rois.shape)} {rois.dtype}")
    if not rois.is_contiguous():
        raise ValueError("rois must be contiguous")
    b, n = rois.shape[:2]
    lists = torch.full((b, h, n), -1, dtype=torch.int32, device=rois.device)
    lens = torch.zeros((b, h), dtype=torch.int32, device=rois.device)
    if b * n * h == 0:
        return lists, lens
    with torch.cuda.device(rois.device):
        rc = _bwd_lib().roi_align_bwd_lists_launch(
            rois.data_ptr(), lists.data_ptr(), lens.data_ptr(), b, n, h, w, int(output_size),
            int(sampling_ratio), float(spatial_scale), cuda_lib.stream_handle(rois),
        )
    cuda_lib.check(rc, "roi_align_bwd_lists_launch")
    return lists, lens
