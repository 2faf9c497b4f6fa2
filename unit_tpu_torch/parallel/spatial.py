"""The 2-D (data x spatial) mesh's backbone: every backbone on bands of the canvas rows.

unit_tpu splits the image height over a second mesh axis and lets XLA's
SPMD partitioner cut the backbone's convolutions spatially, exchange the
halos and gather the map where an op needs it whole (unit_tpu
mesh.py:69-75, train.py:169-181).  The port does the same explicitly:

  * ``parallel.mesh.make_mesh_2d`` places rank r at (r // S, r % S), and
    ``shard_batch_spatial`` gives each spatial rank its band of the image
    rows (``band_rows``: H / S rows; H is a multiple of 16 S, so that
    ResNet-C4's bands split evenly at every stride up to its map's 16);
  * inside ``banded(bands)`` (the 2-D train step) ``WSRCNN.features`` runs
    ``backbone_bands``: each op of the backbone on the band.  Which output
    rows a band holds follows from its input rows by one rule (``Rows``):
    output row i of an op of stride s belongs to the band that holds input
    row s i (the last band takes the rows past it), so the bands of a map
    need not be even: VGG-CNN-F's unpadded 11 x 11 / 4 conv1 and
    InceptionResNetV2's unpadded stride-2 convolutions and pools leave
    bands of unequal height.  A band's output rows o0 .. o1 - 1 of an op
    (kernel k, dilation d, p rows of pad above) read the input rows
    s o0 - p .. s (o1 - 1) - p + d (k - 1): the rows it lacks come from
    the neighbouring bands (the halo), the rows past the canvas's edges are
    the op's pad value (zero for a convolution and for the average pool,
    which counts them; -inf for a max pool), and the rows of its own it
    does not read are cut.  On even bands whose start and height the stride
    divides the halo is ``halo_rows``: p rows from above and
    d (k - 1) + 1 - p - s from below (ResNet-C4's 7 x 7 / 2 stem 3 and 2,
    its max pool 1 and 0, a 3 x 3 conv 1 and 1, a 1 x 1 conv none).  The op
    then runs unpadded along the rows (its own pad along the columns).
    Backward, each halo's gradient goes back to the rank that owns those
    rows and is added to its band.  Every send of an exchange is posted
    before any receive waits (``comm.send_map`` / ``recv_map``: over gloo a
    CUDA tensor is staged through pinned host memory), so no two ranks wait
    for each other.  Pointwise ops (FrozenBN and its epilogue K4, ReLU,
    the cross-channel LRN, the residual sums) run on the bands as they are;
  * ``gather_rows`` gathers the stride-16 map along its rows over the
    spatial group (bands of unequal height padded to the tallest for the
    all-gather, then cut): the RPN, the NMS, the sampling, ROIAlign and the
    heads then run on the whole map on every spatial rank of a data rank.
    Its backward sums the S ranks' (identical) map gradients and keeps this
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
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import comm

STRIDE = 16  # the map's stride: ResNet-C4's bands split evenly up to it


def band_rows(height: int, n: int, index: int, stride: int = STRIDE) -> Tuple[int, int]:
    """[start, stop) of band ``index`` of ``n`` over ``height`` canvas rows;
    a ``ValueError`` naming the height unless every band splits evenly at
    each stride up to ``stride``."""
    if height % (stride * n):
        raise ValueError(f"a canvas of {height} rows does not split into {n} bands at "
                         f"stride {stride}: the height must be a multiple of {stride * n}")
    rows = height // n
    return index * rows, (index + 1) * rows


def halo_rows(kernel: int, stride: int, padding, dilation: int = 1) -> Tuple[int, int]:
    """(rows from the band above, rows from the band below) that an op of
    ``kernel`` / ``stride`` / ``padding`` (rows above, or (above, below))
    needs on an inner band whose start and height ``stride`` divides:
    output row i reads input rows s i - p .. s i - p + d (k - 1)."""
    top = padding if isinstance(padding, int) else padding[0]
    span = dilation * (kernel - 1) + 1
    return top, max(span - top - stride, 0)


@dataclasses.dataclass(frozen=True)
class Rows:
    """Which rows of a map each band holds: band i the rows ``bounds[i]`` ..
    ``bounds[i + 1] - 1`` of ``height`` = ``bounds[-1]``."""

    bounds: Tuple[int, ...]

    @classmethod
    def even(cls, rows: int, n: int) -> "Rows":
        """``n`` bands of ``rows`` rows each."""
        return cls(tuple(i * rows for i in range(n + 1)))

    @property
    def height(self) -> int:
        return self.bounds[-1]

    def count(self, i: int) -> int:
        return self.bounds[i + 1] - self.bounds[i]

    def after(self, kernel: int, stride: int = 1, pad=(0, 0), dilation: int = 1) -> "Rows":
        """The rows of an op's output: output row i to the band that holds
        input row ``stride`` i, the rows past the last band's start to it.
        ``pad``: the op's (above, below) rows.  A ``ValueError`` where a
        band would get none."""
        span = dilation * (kernel - 1) + 1
        out = (self.height + pad[0] + pad[1] - span) // stride + 1
        bounds = tuple(min(-(-a // stride), out) for a in self.bounds[:-1]) + (out,)
        if any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"an op of kernel {kernel}, stride {stride} over the bands "
                             f"{self.bounds} leaves a band without rows ({bounds}): the "
                             f"canvas is too short for {len(bounds) - 1} bands")
        return Rows(bounds)

    def halos(self, i: int, kernel: int, stride: int = 1, pad=(0, 0),
              dilation: int = 1) -> Tuple[int, int]:
        """(rows band ``i`` reads above its own, rows it reads below them)
        for its output rows (``after``); negative: rows at its top or bottom
        that it does not read.  A ``ValueError`` where they pass a
        neighbouring band."""
        out = self.after(kernel, stride, pad, dilation)
        span = dilation * (kernel - 1) + 1
        first, last = out.bounds[i], out.bounds[i + 1] - 1
        above = self.bounds[i] - (stride * first - pad[0])
        below = stride * last - pad[0] + span - self.bounds[i + 1]
        n = len(self.bounds) - 1
        if (i > 0 and above > self.count(i - 1)) or (i < n - 1 and below > self.count(i + 1)):
            raise ValueError(f"band {i} of {self.bounds} reads rows ({above} above, {below} "
                             f"below) past its neighbours for an op of kernel {kernel}")
        return above, below


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
    """The band ``x`` without its first ``cut`` rows, with ``above`` rows of
    the band above and ``below`` of the band below around it (``pad_value``
    past the canvas's edges), while this band's first ``up`` rows go to the
    band above and its last ``down`` rows to the band below.  Backward, the
    halos' gradients go home."""

    @staticmethod
    def forward(ctx, x, bands, above, below, cut, up, down, pad_value):
        ctx.bands, ctx.sizes = bands, (above, below, cut, up, down)
        h = x.shape[2]
        top, bottom = _exchange(bands, x[:, :, :up], x[:, :, h - down:], above, below, x)
        parts = [_edge(x, above, pad_value) if top is None else top, x[:, :, cut:],
                 _edge(x, below, pad_value) if bottom is None else bottom]
        return torch.cat([p for p in parts if p.shape[2]], 2).contiguous(
            memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        bands, (above, below, cut, up, down) = ctx.bands, ctx.sizes
        kept = g.shape[2] - above - below
        gx = g[:, :, above:above + kept].contiguous(memory_format=torch.channels_last)
        if cut:  # the rows this band does not read: no gradient of its own
            gx = torch.cat([gx.new_zeros(gx.shape[:2] + (cut,) + gx.shape[3:]), gx], 2
                           ).contiguous(memory_format=torch.channels_last)
        h = gx.shape[2]
        # the halos' gradients go back to the rows they were copied from:
        # the top halo to the band above's last rows, the bottom one to the
        # band below's first rows
        from_prev, from_next = _exchange(bands, g[:, :, :above], g[:, :, above + kept:],
                                         up, down, gx)
        if from_prev is not None:
            gx[:, :, :up] += from_prev
        if from_next is not None:
            gx[:, :, h - down:] += from_next
        return gx, None, None, None, None, None, None, None


def read_rows(x: torch.Tensor, bands: Bands, rows: Rows, kernel: int, stride: int = 1,
              pad=(0, 0), dilation: int = 1, pad_value: float = 0.0) -> torch.Tensor:
    """The rows that the band ``x`` (of ``rows``) reads for its output rows
    of an op of ``kernel`` / ``stride`` / ``pad`` (above, below) /
    ``dilation`` (``Rows.halos``): its halos fetched, or ``pad_value`` past
    the canvas, and its unread top rows cut.  Unread bottom rows stay: the
    op makes a few rows more, which the caller cuts (``_own``).  No
    exchange where this band and its neighbours read none of each other's
    rows."""
    n, i = len(rows.bounds) - 1, bands.index
    halos = [rows.halos(j, kernel, stride, pad, dilation) for j in range(n)]
    above, below = halos[i]
    up = max(halos[i - 1][1], 0) if i > 0 else 0  # rows the band above reads of this one
    down = max(halos[i + 1][0], 0) if i < n - 1 else 0
    if above <= 0 and below <= 0 and not up and not down:
        return x[:, :, -above:] if above else x
    return _Halo.apply(x, bands, max(above, 0), max(below, 0), max(-above, 0), up, down,
                       pad_value)


def _own(y: torch.Tensor, rows: Rows, bands: Bands) -> torch.Tensor:
    """``y`` cut to this band's rows of ``rows``."""
    n = rows.count(bands.index)
    return y if y.shape[2] == n else y[:, :, :n]


def conv_bands(conv, x: torch.Tensor, bands: Bands, rows: Optional[Rows] = None) -> torch.Tensor:
    """A ``models.resnet.Conv2d`` on the band ``x`` of ``rows`` (None: even
    bands of its height): its halo, then the convolution unpadded along the
    rows; this band's rows of the output."""
    kh = conv.weight.shape[2]
    ph, pw = (conv.padding, conv.padding) if isinstance(conv.padding, int) else conv.padding
    rows = rows or Rows.even(x.shape[2], len(bands.ranks))
    args = (kh, conv.stride, (ph, ph), conv.dilation)
    x = read_rows(x, bands, rows, *args)
    if ph == 0:  # the module's own pad is along the columns alone
        y = conv(x)
    else:
        w = conv.weight.to(dtype=conv.dtype, memory_format=torch.channels_last)
        b = None if conv.bias is None else conv.bias.to(conv.dtype)
        y = F.conv2d(x.to(conv.dtype), w, b, conv.stride, (0, pw), conv.dilation)
    return _own(y, rows.after(*args), bands)


def max_pool_bands(x: torch.Tensor, bands: Bands, kernel: int = 3, stride: int = 2,
                   padding: int = 1, rows: Optional[Rows] = None) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding)`` on the band ``x`` of
    ``rows`` (None: even bands): -inf past the canvas's edges, as the
    pool's own padding."""
    rows = rows or Rows.even(x.shape[2], len(bands.ranks))
    args = (kernel, stride, (padding, padding))
    x = read_rows(x, bands, rows, *args, pad_value=float("-inf"))
    return _own(F.max_pool2d(x, kernel, stride=stride, padding=(0, padding)),
                rows.after(*args), bands)


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


# ------------------------------------------------------ the other backbones
@dataclasses.dataclass(frozen=True)
class BandMap:
    """A band ``x`` (NCHW) of a map whose rows the bands hold as ``rows``,
    and the ops of ``models.backbones`` on it, each giving its output's band."""

    x: torch.Tensor
    rows: Rows
    bands: Bands

    def _with(self, x: torch.Tensor, rows: Optional[Rows] = None) -> "BandMap":
        return BandMap(x, self.rows if rows is None else rows, self.bands)

    def apply(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "BandMap":
        """A pointwise op along the rows (ReLU, the cross-channel LRN)."""
        return self._with(fn(self.x))

    def relu(self) -> "BandMap":
        return self.apply(F.relu)

    def conv(self, conv) -> "BandMap":
        kh = conv.weight.shape[2]
        ph = conv.padding if isinstance(conv.padding, int) else conv.padding[0]
        return self._with(conv_bands(conv, self.x, self.bands, self.rows),
                          self.rows.after(kh, conv.stride, (ph, ph), conv.dilation))

    def max_pool(self, kernel: int, stride: int, pad=(0, 0), right: int = 0) -> "BandMap":
        """An unpadded max pool, or one over ``pad`` (above, below) rows and
        ``right`` columns of -inf (VGG-CNN-F's)."""
        rows = self.rows.after(kernel, stride, pad)
        x = read_rows(self.x, self.bands, self.rows, kernel, stride, pad,
                      pad_value=float("-inf"))
        if right:
            x = F.pad(x, (0, right), value=float("-inf"))
        return self._with(_own(F.max_pool2d(x, kernel, stride), rows, self.bands), rows)

    def avg_pool(self, kernel: int = 3) -> "BandMap":
        """``F.avg_pool2d(x, k, 1, k // 2, count_include_pad=True)``: zeros
        past the canvas's edges, a divisor of k * k everywhere."""
        p = kernel // 2
        x = read_rows(self.x, self.bands, self.rows, kernel, 1, (p, p))
        return self._with(F.avg_pool2d(x, kernel, 1, (0, p), count_include_pad=True))

    @staticmethod
    def cat(maps: List["BandMap"]) -> "BandMap":
        """Branches over one map's rows, joined along the channels."""
        if len({m.rows for m in maps}) != 1:
            raise ValueError(f"branches over other rows: {[m.rows for m in maps]}")
        return maps[0]._with(torch.cat([m.x for m in maps], 1))


def vgg_cnn_f_bands(bb, m: BandMap) -> BandMap:
    """``models.backbones.VGGCNNF.forward`` on a band."""
    m = m.conv(bb.conv1).relu().apply(bb.norm1).max_pool(3, 2, (0, 1), right=1)
    m = m.conv(bb.conv2).relu().apply(bb.norm2).max_pool(3, 2, (0, 1), right=1)
    for conv in (bb.conv3, bb.conv4, bb.conv5):
        m = m.conv(conv).relu()
    return m


def vgg16_bands(bb, m: BandMap) -> BandMap:
    """``models.backbones.VGG16.forward`` on a band."""
    idx = 0
    for n, _ in bb._BLOCKS:
        for _ in range(n):
            m = m.conv(getattr(bb, f"conv{idx}")).relu()
            idx += 1
        m = m.max_pool(2, 2)
    for i in range(idx, idx + 3):
        m = m.conv(getattr(bb, f"conv{i}")).relu()
    return m


def _residual(block, m: BandMap, branches: List[BandMap]) -> BandMap:
    """relu(x + scale * up(branches)) of an Inception-ResNet block."""
    up = BandMap.cat(branches).conv(block.up)
    return m.apply(lambda x: F.relu(x + block.scale * up.x))


def _block35_bands(block, m: BandMap) -> BandMap:
    return _residual(block, m, [
        m.conv(block.b0).relu(),
        m.conv(block.b1_0).relu().conv(block.b1_1).relu(),
        m.conv(block.b2_0).relu().conv(block.b2_1).relu().conv(block.b2_2).relu()])


def _block17_bands(block, m: BandMap) -> BandMap:
    return _residual(block, m, [
        m.conv(block.b0).relu(),
        m.conv(block.b1_0).relu().conv(block.b1_1).relu().conv(block.b1_2).relu()])


def inception_resnet_v2_bands(bb, m: BandMap) -> BandMap:
    """``models.backbones.InceptionResNetV2.forward`` on a band."""
    for conv in (bb.conv2d_1a, bb.conv2d_2a, bb.conv2d_2b):
        m = m.conv(conv).relu()
    m = m.max_pool(3, 2).conv(bb.conv2d_3b).relu().conv(bb.conv2d_4a).relu().max_pool(3, 2)
    m = BandMap.cat([
        m.conv(bb.m5b_b0).relu(),
        m.conv(bb.m5b_b1_0).relu().conv(bb.m5b_b1_1).relu(),
        m.conv(bb.m5b_b2_0).relu().conv(bb.m5b_b2_1).relu().conv(bb.m5b_b2_2).relu(),
        m.avg_pool(3).conv(bb.m5b_b3).relu()])
    for i in range(bb.num_block35):
        m = _block35_bands(getattr(bb, f"block35_{i}"), m)
    m = BandMap.cat([
        m.conv(bb.m6a_b0).relu(),
        m.conv(bb.m6a_b1_0).relu().conv(bb.m6a_b1_1).relu().conv(bb.m6a_b1_2).relu(),
        m.max_pool(3, 2)])
    for i in range(bb.num_block17):
        m = _block17_bands(getattr(bb, f"block17_{i}"), m)
    return m


def backbone_bands(backbone, x: torch.Tensor, bands: Bands):
    """(this rank's band of the backbone's map, NCHW channels_last; the
    map's ``Rows``, None for even bands) from its band ``x`` [B, h, W, 3]
    of the preprocessed images (the canvas's even bands)."""
    from ..models.backbones import VGG16, InceptionResNetV2, VGGCNNF
    from ..models.resnet import ResNetC4

    if isinstance(backbone, ResNetC4):
        return resnet_c4_bands(backbone, x, bands), None
    forward = {VGG16: vgg16_bands, VGGCNNF: vgg_cnn_f_bands,
               InceptionResNetV2: inception_resnet_v2_bands}[type(backbone)]
    m = forward(backbone, BandMap(x.permute(0, 3, 1, 2).to(backbone.dtype),
                                  Rows.even(x.shape[1], len(bands.ranks)), bands))
    return m.x.contiguous(memory_format=torch.channels_last), m.rows


# ---------------------------------------------------------------- the gather
def _gather(y: torch.Tensor, bands: Bands, rows: Rows) -> torch.Tensor:
    """The spatial ranks' [B, h, w, C] bands of ``rows`` joined along the
    rows (each padded to the tallest for the all-gather, then cut)."""
    counts = [rows.count(i) for i in range(len(bands.ranks))]
    y = y.contiguous()
    if y.shape[1] < max(counts):
        y = torch.cat([y, y.new_zeros((y.shape[0], max(counts) - y.shape[1]) + y.shape[2:])], 1)
    parts = [torch.empty_like(y) for _ in bands.ranks]
    dist.all_gather(parts, y, group=bands.group)
    return torch.cat([p if p.shape[1] == c else p[:, :c] for p, c in zip(parts, counts)], 1)


def _scatter_sum(g: torch.Tensor, bands: Bands, rows: Rows) -> torch.Tensor:
    """This band's rows of ``g`` summed over the spatial ranks, dense."""
    g = g.contiguous().clone()
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=bands.group)
    return g.narrow(1, rows.bounds[bands.index], rows.count(bands.index)).contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bands, rows):
        ctx.bands, ctx.rows = bands, rows
        return _gather(y, bands, rows)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.bands, ctx.rows), None, None


def gather_rows(y: torch.Tensor, bands: Bands, rows: Optional[Rows] = None) -> torch.Tensor:
    """The spatial ranks' bands [B, h, w, C] of a map (of ``rows``; None:
    even bands of ``y``'s height) joined along the rows into the whole map,
    top band first; backward, this band's rows of the map gradient summed
    over the spatial ranks.  One band: ``y``."""
    if len(bands.ranks) == 1:
        return y
    return _GatherRows.apply(y, bands, rows or Rows.even(y.shape[1], len(bands.ranks)))


__all__ = ["BandMap", "Bands", "Rows", "backbone_bands", "band_rows", "banded", "bands_of",
           "conv_bands", "gather_rows", "halo_rows", "max_pool_bands", "read_rows",
           "resnet_c4_bands"]
