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
  * another backbone than ResNet-C4 under ``spatial.banded`` raises
    ``NotImplementedError`` naming its ROADMAP item, and the banded
    ``features`` of a ResNet-C4 of one band equals the plain ``features``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_parallel_run import params_digest
from tests.test_torch_pipeline_run import small_model
from unit_tpu_torch.parallel import comm, spatial
from unit_tpu_torch.parallel import mesh as mesh_lib

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


def test_other_backbones_raise_under_the_2d_mesh():
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.models import WSRCNN, ModelConfig

    cfg = get_cfg()
    cfg.merge_from_file("configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml")
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    with spatial.banded(spatial.Bands(None, (0,), 0)):
        with pytest.raises(NotImplementedError, match="2-D .* mesh over VGG.*item 41"):
            model.features(torch.zeros(1, 64, 64, 3))


def test_one_band_features_equal_the_plain_features():
    _, model = small_model()
    images = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(3)) * 255
    with torch.no_grad():
        want = model.features(images)
        with spatial.banded(spatial.Bands(None, (0,), 0)):
            got = model.features(images)
    assert torch.equal(got, want)


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


def rank_spatial(device, params, strong, weak):
    """At world 4: (a) each op of ``OPS`` on a (1, 4) mesh's bands against
    the whole op; (b) one 2-D step at (2, 2) (metrics, update, digest) and
    (c) the same with TPU.REMAT_BACKBONE (metrics, update), both from
    ``params``; (d) the refusals; (e) this rank's part of a batch with
    ``gt_masks``."""
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
    return out
