"""The 2-D (data x spatial) mesh's backbone: ResNet-C4 on bands of the canvas rows.

unit_tpu splits the image height over a second mesh axis and lets XLA's
SPMD partitioner cut the backbone's convolutions spatially, exchange the
halos and gather the map where an op needs it whole (unit_tpu
mesh.py:69-75, train.py:169-181).  The port does the same explicitly:

  * ``parallel.mesh.make_mesh_2d`` places rank r at (r // S, r % S), and
    ``shard_batch_spatial`` gives each spatial rank its band of the image
    rows (``band_rows``: H / S rows; the bands must split evenly at every
    stride up to the map's 16, so H is a multiple of 16 S);
  * inside ``banded(bands)`` (the 2-D train step) ``WSRCNN.features`` runs
    ``resnet_c4_bands``: the stem, the max pool and every bottleneck block
    on the band.  An op of (kernel k, stride s, pad p) over rows needs
    ``halo_rows``: p rows from the band above and k - p - s from the band
    below (the 7x7 / 2 stem 3 and 2, the 3 x 3 / 2 max pool 1 and 0, a 3 x 3
    / 1 conv 1 and 1, a 1 x 1 conv none).  ``halo`` fetches them from the
    neighbours, or pads the global edges with the op's own value (zero for
    a convolution, -inf for the max pool), and the op then runs unpadded
    along the rows (its own pad along the columns).  Backward, each halo's
    gradient goes back to the rank that owns those rows and is added to its
    band.  Every send of an exchange is posted before any receive waits
    (``comm.send_map`` / ``recv_map``: over gloo a CUDA tensor is staged
    through pinned host memory), so no two ranks wait for each other.
    FrozenBN and its epilogue (K4) are pointwise and run on the bands as
    they are;
  * ``gather_rows`` gathers the stride-16 map along its rows over the
    spatial group: the RPN, the NMS, the sampling, ROIAlign and the heads
    then run on the whole map on every spatial rank of a data rank.  Its
    backward sums the S ranks' (identical) map gradients and keeps this
    band's rows (a reduce-scatter, as an all-reduce and a slice: gloo has
    no reduce-scatter), so each backbone gradient comes out S times this
    band's share and each head gradient S times the whole; the train
    step's one all-reduce over the D x S world, divided by D x S, is then
    the data ranks' mean.

Why not DTensor's convolution (torch/distributed/tensor/_tp_conv.py): it
splits only the last dimension and refuses a strided convolution with
padding, which the stem is.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import comm

STRIDE = 16  # ResNet-C4's output stride: every band splits evenly up to it


def band_rows(height: int, n: int, index: int, stride: int = STRIDE) -> Tuple[int, int]:
    """[start, stop) of band ``index`` of ``n`` over ``height`` canvas rows;
    a ``ValueError`` naming the height unless every band splits evenly at
    each stride up to ``stride``."""
    if height % (stride * n):
        raise ValueError(f"a canvas of {height} rows does not split into {n} bands at "
                         f"stride {stride}: the height must be a multiple of {stride * n}")
    rows = height // n
    return index * rows, (index + 1) * rows


def halo_rows(kernel: int, stride: int, padding: int, dilation: int = 1) -> Tuple[int, int]:
    """(rows from the band above, rows from the band below) that an op of
    ``kernel`` / ``stride`` / ``padding`` needs on a band whose start and
    height ``stride`` divides: output row i reads input rows s i - p ..
    s i - p + d (k - 1)."""
    span = dilation * (kernel - 1) + 1
    return padding, max(span - padding - stride, 0)


@dataclasses.dataclass(frozen=True)
class Bands:
    """This rank's place among the spatial ranks of its data rank: their
    process ``group``, their global ``ranks`` top band first, and this
    rank's ``index`` among them."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def prev(self) -> Optional[int]:
        """The global rank of the band above (None at the top)."""
        return self.ranks[self.index - 1] if self.index > 0 else None

    @property
    def next(self) -> Optional[int]:
        """The global rank of the band below (None at the bottom)."""
        return self.ranks[self.index + 1] if self.index + 1 < len(self.ranks) else None


def bands_of(mesh) -> Bands:
    """This rank's ``Bands`` on a ``make_mesh_2d`` mesh."""
    from .mesh import SPATIAL_AXIS

    group = mesh.get_group(SPATIAL_AXIS)
    return Bands(group, tuple(dist.get_process_group_ranks(group)),
                 mesh.get_local_rank(SPATIAL_AXIS))


_ACTIVE = contextvars.ContextVar("spatial_bands", default=None)


@contextlib.contextmanager
def banded(bands: Optional[Bands]):
    """Within the block ``WSRCNN.features`` takes its images as this rank's
    band of ``bands`` (None: whole images again)."""
    token = _ACTIVE.set(bands)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Bands]:
    """The ``Bands`` of the enclosing ``banded`` block, or None."""
    return _ACTIVE.get()


# ------------------------------------------------------------------ the halo
def _rows_out(t: torch.Tensor) -> torch.Tensor:
    """NCHW rows as the dense [N, rows, W, C] message."""
    return t.permute(0, 2, 3, 1).contiguous()


def _exchange(bands: Bands, to_prev: Optional[torch.Tensor], to_next: Optional[torch.Tensor],
              from_prev: int, from_next: int, like: torch.Tensor):
    """Send NCHW rows ``to_prev`` / ``to_next`` to the neighbouring bands
    (None or no rows: nothing) and receive ``from_prev`` / ``from_next``
    rows from them: (rows from prev, rows from next), NCHW channels_last,
    None where nothing came.  Every send is posted before the receives."""
    pending: List[Any] = []
    for t, dst in ((to_prev, bands.prev), (to_next, bands.next)):
        if dst is not None and t is not None and t.shape[2]:
            pending += comm.send_map(_rows_out(t), dst)
    n, c, _, w = like.shape
    got = []
    for rows, src in ((from_prev, bands.prev), (from_next, bands.next)):
        got.append(None if src is None or not rows else comm.recv_map(
            (n, rows, w, c), like.dtype, src, like.device).permute(0, 3, 1, 2))
    comm.wait_all(pending)
    return tuple(got)


def _edge(like: torch.Tensor, rows: int, value: float) -> torch.Tensor:
    n, c, _, w = like.shape
    return torch.full((n, c, rows, w), value, dtype=like.dtype, device=like.device
                      ).contiguous(memory_format=torch.channels_last)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bands, above, below, pad_value):
        ctx.bands, ctx.above, ctx.below = bands, above, below
        h = x.shape[2]
        top, bottom = _exchange(bands, x[:, :, :below], x[:, :, h - above:], above, below, x)
        parts = [_edge(x, above, pad_value) if top is None else top, x,
                 _edge(x, below, pad_value) if bottom is None else bottom]
        return torch.cat([p for p in parts if p.shape[2]], 2).contiguous(
            memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        bands, above, below = ctx.bands, ctx.above, ctx.below
        h = g.shape[2] - above - below
        gx = g[:, :, above:above + h].contiguous(memory_format=torch.channels_last)
        # the halos' gradients go back to the rows they were copied from:
        # the top halo to the band above's last rows, the bottom one to the
        # band below's first rows
        from_prev, from_next = _exchange(bands, g[:, :, :above], g[:, :, above + h:],
                                         below, above, gx)
        if from_prev is not None:
            gx[:, :, :below] += from_prev
        if from_next is not None:
            gx[:, :, h - above:] += from_next
        return gx, None, None, None, None


def halo(x: torch.Tensor, bands: Bands, above: int, below: int,
         pad_value: float = 0.0) -> torch.Tensor:
    """The NCHW band ``x`` with ``above`` rows of the band above and
    ``below`` of the band below around it (``pad_value`` past the canvas's
    edges), channels_last; backward, the halos' gradients go home."""
    if not above and not below:
        return x
    return _Halo.apply(x, bands, above, below, pad_value)


def conv_bands(conv, x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """A ``models.resnet.Conv2d`` on the band ``x``: its halo, then the
    convolution unpadded along the rows."""
    kh = conv.weight.shape[2]
    ph, pw = (conv.padding, conv.padding) if isinstance(conv.padding, int) else conv.padding
    if kh == 1 and ph == 0:
        return conv(x)
    x = halo(x, bands, *halo_rows(kh, conv.stride, ph, conv.dilation))
    w = conv.weight.to(dtype=conv.dtype, memory_format=torch.channels_last)
    b = None if conv.bias is None else conv.bias.to(conv.dtype)
    return F.conv2d(x.to(conv.dtype), w, b, conv.stride, (0, pw), conv.dilation)


def max_pool_bands(x: torch.Tensor, bands: Bands, kernel: int = 3, stride: int = 2,
                   padding: int = 1) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding)`` on the band ``x``: -inf
    past the canvas's edges, as the pool's own padding."""
    x = halo(x, bands, *halo_rows(kernel, stride, padding), pad_value=float("-inf"))
    return F.max_pool2d(x, kernel, stride=stride, padding=(0, padding))


def _block_bands(block, x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """``models.resnet.BottleneckBlock.forward`` on a band: the 3 x 3 conv
    takes its halo, the 1 x 1 convs and the epilogues need none."""
    out = block.conv1_bn(block.conv1(x), relu=True)
    out = block.conv2_bn(conv_bands(block.conv2, out, bands), relu=True)
    sc = x if block.shortcut is None else block.shortcut_bn(block.shortcut(x))
    return block.conv3_bn(block.conv3(out), residual=sc, relu=True)


def resnet_c4_bands(backbone, x: torch.Tensor, bands: Bands) -> torch.Tensor:
    """``models.resnet.ResNetC4.forward`` on this rank's band ``x`` [B, h,
    W, 3] of the preprocessed images: its band [B, C, h / 16, W / 16] of the
    stride-16 map (NCHW, channels_last memory)."""
    x = x.permute(0, 3, 1, 2).to(backbone.dtype)
    x = backbone.stem_conv1_bn(conv_bands(backbone.stem_conv1, x, bands), relu=True)
    x = max_pool_bands(x, bands)
    for stage in (backbone.res2, backbone.res3, backbone.res4):
        for i in range(stage.num_blocks):
            x = _block_bands(getattr(stage, f"block{i}"), x, bands)
    return x


# ---------------------------------------------------------------- the gather
def _gather(y: torch.Tensor, bands: Bands) -> torch.Tensor:
    """The spatial ranks' [B, h, w, C] bands joined along the rows."""
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in bands.ranks]
    dist.all_gather(parts, y, group=bands.group)
    return torch.cat(parts, 1)


def _scatter_sum(g: torch.Tensor, bands: Bands, rows: int) -> torch.Tensor:
    """This band's ``rows`` of ``g`` summed over the spatial ranks, dense."""
    g = g.contiguous().clone()
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=bands.group)
    return g.narrow(1, bands.index * rows, rows).contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bands):
        ctx.bands, ctx.rows = bands, y.shape[1]
        return _gather(y, bands)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.bands, ctx.rows), None


def gather_rows(y: torch.Tensor, bands: Bands) -> torch.Tensor:
    """The spatial ranks' bands [B, h, w, C] of a map joined along the rows
    into the whole map, top band first; backward, this band's rows of the
    map gradient summed over the spatial ranks.  One band: ``y``."""
    return y if len(bands.ranks) == 1 else _GatherRows.apply(y, bands)


__all__ = ["Bands", "band_rows", "banded", "bands_of", "conv_bands", "gather_rows", "halo",
           "halo_rows", "max_pool_bands", "resnet_c4_bands"]
