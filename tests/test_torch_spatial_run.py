"""The 2-D (data x spatial) mesh of unit_tpu_torch on the CPU: ranks over gloo.

This module imports no jax: the ranks import it to find ``rank_spatial``,
which tests/test_torch_spatial.py spawns once at world 4 and holds against
unit_tpu.  Here, in one process:

  * ``band_rows`` and ``halo_rows``: the bands of the canvas rows, the
    ValueError naming a height that does not split evenly at stride 16, and
    each ResNet-C4 op's halo (the stem 3 + 2 rows, the max pool 1 + 0, a
    3 x 3 conv 1 + 1, a strided 3 x 3 conv 1 + 0, a 1 x 1 conv none);
  * a band with no neighbours is the whole op (the edges padded as the op
    pads);
  * the halos of the other backbones' ops, unpadded, strided past their
    kernel's reach, dilated or padded on one side (VGG-CNN-F's 11 x 11 / 4
    conv1 and its bottom-right max pool, InceptionResNetV2's unpadded
    3 x 3 / 2 ops and its 7 x 1 conv, VGG16's 2 x 2 pool and dilated
    conv5), and ``Rows``: the uneven bands an op's output rows fall into
    and each band's halo on the dock recipe's canvas, and the ValueError
    where a band would hold no rows;
  * the banded ``features`` of one band equals the plain ``features``, bit
    for bit, for a ResNet-C4 and the note recipe's InceptionResNetV2 (the
    model's), and VGG-CNN-F and a dilated VGG16 (the backbones').

``rank_spatial`` also holds each of those three backbones on two bands
against the whole one (tests/test_torch_spatial.py).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_parallel_run import params_digest
from tests.test_torch_pipeline_run import small_model
from unit_tpu_torch.parallel import comm, spatial
from unit_tpu_torch.parallel import mesh as mesh_lib

@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while the module runs (the note's and the dock's
    models, as tests/test_torch_note.py's): torch's one thread per core
    oversubscribes a machine that runs several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# (name, kernel, stride, pad): the ops of ResNet-C4 on the rows, and the 3 x 3
# conv a stride_in_1x1=False block would stride
OPS = [("stem_7x7_s2", 7, 2, 3), ("max_pool_3x3_s2", 3, 2, 1), ("conv_3x3", 3, 1, 1),
       ("conv_1x1_s2", 1, 2, 0), ("conv_3x3_s2", 3, 2, 1)]
HALO_ROWS = {"stem_7x7_s2": (3, 2), "max_pool_3x3_s2": (1, 0), "conv_3x3": (1, 1),
             "conv_1x1_s2": (0, 0), "conv_3x3_s2": (1, 0)}


def op_pair(name, kernel, stride, pad):
    """(whole op, banded op) of one of ``OPS``: a seeded f32 ``Conv2d`` of 4
    channels, or the max pool."""
    from unit_tpu_torch.models.resnet import Conv2d

    if name.startswith("max_pool"):
        return (lambda x: F.max_pool2d(x, kernel, stride, pad),
                lambda x, bands: spatial.max_pool_bands(x, bands, kernel, stride, pad))
    conv = Conv2d(4, 4, kernel, stride=stride, padding=pad,
                  generator=torch.Generator().manual_seed(kernel * 10 + stride))
    return conv, lambda x, bands: spatial.conv_bands(conv, x, bands)


def op_input(name, h=32, w=12):
    """A seeded [2, 4, h, w] channels_last input; all negative for the max
    pool, so a zero pad at a band's edge would show."""
    x = torch.randn(2, 4, h, w, generator=torch.Generator().manual_seed(len(name)))
    if name.startswith("max_pool"):
        x = x - 10.0
    return x.contiguous(memory_format=torch.channels_last)


def band_vs_whole(name, kernel, stride, pad, bands, n, index):
    """(output error, input-gradient error) of the banded op on band
    ``index`` of ``n`` against the whole op, each over the whole's largest
    magnitude."""
    whole, banded = op_pair(name, kernel, stride, pad)
    x = op_input(name).requires_grad_(True)
    y = whole(x)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    (y * gy).sum().backward()
    a, b = spatial.band_rows(x.shape[2], n, index, stride=stride)
    xb = x.detach()[:, :, a:b].contiguous(memory_format=torch.channels_last).requires_grad_(True)
    yb = banded(xb, bands)
    rows = slice(a // stride, b // stride)
    (yb * gy[:, :, rows]).sum().backward()
    fwd = (yb - y[:, :, rows]).detach().abs().max() / y.detach().abs().max()
    grad = (xb.grad - x.grad[:, :, a:b]).abs().max() / x.grad.abs().max()
    return float(fwd), float(grad)


def test_band_rows():
    assert [spatial.band_rows(800, 2, i) for i in range(2)] == [(0, 400), (400, 800)]
    assert spatial.band_rows(1344, 2, 1) == (672, 1344)  # 42 rows a band at stride 16
    with pytest.raises(ValueError, match="150 rows"):
        spatial.band_rows(150, 2, 0)
    with pytest.raises(ValueError, match="multiple of 64"):
        spatial.band_rows(96, 4, 0)


@pytest.mark.parametrize("name,kernel,stride,pad", OPS, ids=[o[0] for o in OPS])
def test_halo_rows(name, kernel, stride, pad):
    assert spatial.halo_rows(kernel, stride, pad) == HALO_ROWS[name]


@pytest.mark.parametrize("name,kernel,stride,pad", OPS, ids=[o[0] for o in OPS])
def test_one_band_is_the_whole_op(name, kernel, stride, pad):
    fwd, grad = band_vs_whole(name, kernel, stride, pad, spatial.Bands(None, (0,), 0), 1, 0)
    assert fwd == 0.0 and grad == 0.0


# (name, kernel, stride, pad (above, below), dilation, halo rows on an inner band)
OTHER_OPS = [("cnnf_conv1_11x11_s4", 11, 4, (0, 0), 1, (0, 7)),
             ("cnnf_pool_3x3_s2_bottom", 3, 2, (0, 1), 1, (0, 1)),
             ("irv2_conv_3x3_s2_valid", 3, 2, (0, 0), 1, (0, 1)),
             ("irv2_conv_3x3_valid", 3, 1, (0, 0), 1, (0, 2)),
             ("irv2_conv_7x1", 7, 1, (3, 3), 1, (3, 3)),
             ("vgg16_pool_2x2_s2", 2, 2, (0, 0), 1, (0, 0)),
             ("vgg16_dilated_3x3", 3, 1, (2, 2), 2, (2, 2))]


@pytest.mark.parametrize("name,kernel,stride,pad,dilation,want", OTHER_OPS,
                         ids=[o[0] for o in OTHER_OPS])
def test_halo_rows_of_the_other_backbones(name, kernel, stride, pad, dilation, want):
    assert spatial.halo_rows(kernel, stride, pad, dilation) == want
    rows = spatial.Rows.even(8 * stride, 3)  # the middle band of three, stride-aligned
    assert rows.halos(1, kernel, stride, pad, dilation) == want


def test_rows_of_the_dock_canvas():
    """VGG-CNN-F over the two bands of a 1216-row canvas: conv1's 302 rows
    split 152 / 150 (row i to the band holding row 4 i), band 0 reads 7 rows
    of band 1 and band 1 leaves its last row unread; the bottom-right pool
    then reads one row of band 1 and one -inf row past the canvas."""
    rows = spatial.Rows.even(608, 2)
    conv1 = rows.after(11, 4)
    assert conv1.bounds == (0, 152, 302)
    assert [rows.halos(i, 11, 4) for i in range(2)] == [(0, 7), (0, -1)]
    pool = conv1.after(3, 2, (0, 1))
    assert pool.bounds == (0, 76, 151)
    assert [conv1.halos(i, 3, 2, (0, 1)) for i in range(2)] == [(0, 1), (0, 1)]
    # unaligned starts: band 1 cuts the rows before its first window
    assert spatial.Rows((0, 5, 11)).after(3, 2).bounds == (0, 3, 5)
    assert spatial.Rows((0, 5, 11)).halos(1, 3, 2) == (-1, 0)


def test_rows_refuse_a_band_without_rows():
    with pytest.raises(ValueError, match="leaves a band without rows"):
        spatial.Rows.even(4, 2).after(7, 4)
    with pytest.raises(ValueError, match="past its neighbours"):
        spatial.Rows((0, 2, 10)).halos(1, 7, 1, (3, 3))


def other_backbone(name):
    """(the plain map of seeded images, the map of one band, as the 2-D step
    gathers it) of the note recipe's InceptionResNetV2 through
    ``WSRCNN.features``, and of VGG-CNN-F (the dock's) and a dilated VGG16
    alone."""
    images = torch.rand(1, 96, 64, 3, generator=torch.Generator().manual_seed(3)) * 255
    one = spatial.Bands(None, (0,), 0)
    if name == "note":
        from unit_tpu_torch.config import get_cfg
        from unit_tpu_torch.models import WSRCNN, ModelConfig

        cfg = get_cfg()
        cfg.merge_from_file("configs/COCO/COCO-RCNN-50-C4-split1-note.yaml")
        model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            want = model.features(images)
            with spatial.banded(one):
                return want, model.features(images)
    from unit_tpu_torch.models.backbones import VGG16, VGGCNNF

    g = torch.Generator().manual_seed(0)
    bb = VGGCNNF(generator=g) if name == "vgg_cnn_f" else VGG16(dilated=True, generator=g)
    with torch.no_grad():
        y, rows = spatial.backbone_bands(bb, images, one)
        return bb(images).permute(0, 2, 3, 1), spatial.gather_rows(
            y.permute(0, 2, 3, 1), one, rows)


def test_one_band_features_equal_the_plain_features():
    _, model = small_model()
    images = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(3)) * 255
    with torch.no_grad():
        want = model.features(images)
        with spatial.banded(spatial.Bands(None, (0,), 0)):
            got = model.features(images)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["vgg_cnn_f", "note", "vgg16_dilated"])
def test_other_backbones_one_band_features_equal_the_plain_features(name):
    want, got = other_backbone(name)
    assert got.shape == want.shape and torch.equal(got, want)


# ------------------------------------------------------------------ the ranks
def tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def spatial_step(params, strong, weak, mesh, *opts):
    """One 2-D step of the small flagship from ``params`` on this rank's
    ``shard_batch_spatial`` part of the global batches, seeded by its data
    rank: (the world's mean losses, the update, the model)."""
    from unit_tpu_torch.checkpoint import flax_leaves
    from unit_tpu_torch.engine import make_train_step
    from unit_tpu_torch.engine.train import step_seed
    from unit_tpu_torch.solver import build_optimizer

    cfg, model = small_model(params, *opts)
    solver = build_optimizer(cfg, model)
    step = make_train_step(model, solver.optimizer, solver.scheduler, solver.clip, mesh=mesh)
    before = flax_leaves(model)
    s, w = (mesh_lib.shard_batch_spatial(mesh, tensors(b)) for b in (strong, weak))
    n_spatial = mesh_lib.axis_size(mesh, mesh_lib.SPATIAL_AXIS)
    g = torch.Generator().manual_seed(step_seed(0, 0, rank=comm.data_rank(n_spatial)))
    losses = step(s, w, g)
    values = comm.all_reduce_mean(torch.stack(list(losses.values())).float())
    metrics = dict(zip(losses, values.tolist()))
    return metrics, {k: v - before[k] for k, v in flax_leaves(model).items()}, model


def refusals(mesh, params, strong):
    """The messages of what the 2-D mesh refuses."""
    from unit_tpu_torch.engine import TrainerNoMeta, make_train_step
    from unit_tpu_torch.solver import build_optimizer

    cfg, model = small_model(params)
    solver = build_optimizer(cfg, model)
    out = {}
    for name, call in (
            ("height", lambda: mesh_lib.shard_batch_spatial(
                mesh, dict(strong, image=strong["image"][:, :150]))),
            ("grad_accum", lambda: make_train_step(model, solver.optimizer, solver.scheduler,
                                                   solver.clip, grad_accum=2, mesh=mesh)),
            ("trainer", lambda: TrainerNoMeta(model, solver, mesh=mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# backbone: the seeded images' shape [B, H, W, 3]; each band of the map
# holds at least the rows its neighbour's widest op reads (the 7 x 1 conv's 3)
BACKBONES = {"vgg_cnn_f": (1, 96, 80, 3), "inception_resnet_v2": (1, 160, 64, 3),
             "vgg16_dilated": (1, 96, 48, 3)}


def backbone_on_bands(name, bands):
    """(map error, input-gradient error, worst parameter-gradient error, the
    map's row bounds) of the f32 backbone ``name`` (full depth, seeded) on
    ``bands`` against the whole backbone on the same images, each error over
    the whole's largest magnitude: the map gathered whole, the input
    gradient of this band, the parameter gradients summed over the bands
    (each S times its band's share, as the 2-D step leaves them)."""
    from unit_tpu_torch.models.backbones import VGG16, InceptionResNetV2, VGGCNNF

    bb = {"vgg_cnn_f": VGGCNNF, "inception_resnet_v2": InceptionResNetV2,
          "vgg16_dilated": functools.partial(VGG16, dilated=True)}[name](
        generator=torch.Generator().manual_seed(0))
    shape, n = BACKBONES[name], len(bands.ranks)
    x = (torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 4 - 2
         ).requires_grad_(True)
    y = bb(x).permute(0, 2, 3, 1)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    (y * gy).sum().backward()
    whole = {k: p.grad.clone() for k, p in bb.named_parameters()}
    bb.zero_grad()
    a, b = bands.index * shape[1] // n, (bands.index + 1) * shape[1] // n
    xb = x.detach()[:, a:b].clone().requires_grad_(True)
    yb, rows = spatial.backbone_bands(bb, xb, bands)
    got = spatial.gather_rows(yb.permute(0, 2, 3, 1), bands, rows)
    (got * gy).sum().backward()
    fwd = (got - y).detach().abs().max() / y.detach().abs().max()
    grad = (xb.grad / n - x.grad[:, a:b]).abs().max() / x.grad.abs().max()
    worst = 0.0
    for k, p in bb.named_parameters():
        g = comm.all_reduce_sum(p.grad.clone(), bands.group) / n
        worst = max(worst, float((g - whole[k]).abs().max() / whole[k].abs().max()))
    return float(fwd), float(grad), worst, rows.bounds


def rank_spatial(device, params, strong, weak):
    """At world 4: (a) each op of ``OPS`` on a (1, 4) mesh's bands against
    the whole op; (b) one 2-D step at (2, 2) (metrics, update, digest) and
    (c) the same with TPU.REMAT_BACKBONE (metrics, update), both from
    ``params``; (d) the refusals; (e) this rank's part of a batch with
    ``gt_masks``; (f) each of ``BACKBONES`` on the (2, 2) mesh's two bands
    against the whole backbone (``backbone_on_bands``)."""
    out = {"coords": None}
    line = mesh_lib.make_mesh_2d(1, comm.world(), "cpu")
    bands = spatial.bands_of(line)
    out["halo"] = {name: band_vs_whole(name, k, s, p, bands, comm.world(), bands.index)
                   for name, k, s, p in OPS}
    mesh = mesh_lib.make_mesh_2d(2, 2, "cpu")
    out["coords"] = (mesh.get_local_rank(mesh_lib.DATA_AXIS),
                     mesh.get_local_rank(mesh_lib.SPATIAL_AXIS), comm.data_rank(2))
    metrics, update, model = spatial_step(params, strong, weak, mesh)
    out["step"] = (metrics, update, params_digest(model))
    metrics, update, model = spatial_step(params, strong, weak, mesh,
                                          "TPU.REMAT_BACKBONE", "True")
    out["remat"] = (model.mc.remat_backbone, metrics, update)
    out["refusals"] = refusals(mesh, params, strong)
    masks = dict(strong, gt_masks=np.zeros((4, 4, 28, 28), np.float32))
    out["part"] = {k: tuple(v.shape) for k, v in mesh_lib.shard_batch_spatial(mesh, masks).items()}
    out["backbones"] = {name: backbone_on_bands(name, spatial.bands_of(mesh)) for name in BACKBONES}
    return out
