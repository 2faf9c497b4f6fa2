"""The 2-D (data x spatial) mesh of unit_tpu_torch against unit_tpu's, on the CPU.

unit_tpu's 2-D mesh is its jitted step over ``make_mesh_2d`` with the images
split on (batch, height) by ``shard_batch_spatial`` (the conftest's fake CPU
devices): XLA's SPMD partitioner cuts the backbone's convolutions along the
rows and places the halo exchanges and the gathers itself.  The port's is
one gloo rank a mesh position, the backbone on bands of the canvas rows with
explicit halos and one gather of the stride-16 map (``parallel.spatial``;
the ranks' function ``rank_spatial`` lives in the jax-free
tests/test_torch_spatial_run.py).  One spawn at world 4 holds:

  * each halo op of ResNet-C4 (the 7x7 / 2 stem, the 3x3 / 2 max pool with
    its -inf edge, a 3x3 conv, a 1x1 / 2 conv, a 3x3 / 2 conv) on four
    bands against the whole op: outputs and input gradients within 1e-6 of
    the largest value, f32;
  * the step at (2, 2) against unit_tpu's ``make_mesh_2d(2, 2)`` step on
    the same weights and global batch (tests/test_torch_parallel.py's small
    flagship, 4 + 4 images of 160 x 224: 80 rows a band): the losses to
    rtol 2e-4, atol 1e-5 (unit_tpu's own bound for its 2-D step,
    tests/test_parallel.py), each leaf's update to 2e-3 * max|update_jax| +
    1e-9 (the pipeline tests' bound);
  * the same step against the port's one-process step on the whole batch,
    to the same bounds, and the four ranks bit-identical after it;
  * TPU.REMAT_BACKBONE under the 2-D mesh (the recompute runs the halo
    exchanges again in backward): bit-identical to the key off;
  * the refusals: a canvas height that does not split evenly, GRAD_ACCUM 2,
    and the trainer (R19), each a ValueError with its message; a
    ``gt_masks`` array stays whole (the band is keyed on ``image``);
  * VGG-CNN-F, InceptionResNetV2 and a dilated VGG16, each whole in f32, on
    the two bands of a spatial group against the backbone whole: the
    gathered map, the input gradient and every parameter gradient within
    1e-5 of the largest value, the map's rows split unevenly where the
    backbone's unpadded strided ops leave them so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_losses import jax_params
from tests.test_torch_parallel import global_batch, jax_cfg, worst_update
from tests.test_torch_parallel_run import small_trainer, spawn
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from tests.test_torch_spatial_run import BACKBONES, OPS, rank_spatial
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import make_train_step as jmake_train_step
from unit_tpu.parallel import replicate
from unit_tpu.parallel.mesh import make_mesh_2d, shard_batch_spatial
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint.jax_params import flatten_tree

TIMEOUT = 150  # seconds: the group's collectives and the join
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5
HALO_REL = 1e-6
BACKBONE_REL = 1e-5


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """unit_tpu's (2, 2) step, the port's one-process step on the global
    batch, and the world-4 spawn (``rank_spatial``)."""
    cfg = jax_cfg()
    jm, params = jax_params(cfg)
    before = flatten_tree(jax.tree.map(np.asarray, params))
    strong, weak = global_batch(1)
    mesh = make_mesh_2d(2, 2)
    tx = jbuild_optimizer(cfg, params)
    state = replicate(mesh, JTrainState(params=params, opt_state=tx.init(params),
                                        step=jnp.zeros((), jnp.int32)))
    new_state, metrics = jmake_train_step(jm, tx, mesh=mesh)(
        state, shard_batch_spatial(mesh, strong), shard_batch_spatial(mesh, weak), None,
        jax.random.PRNGKey(0))
    after = flatten_tree(jax.tree.map(np.asarray, jax.device_get(new_state.params)))
    want = {k: after[k] - before[k] for k in before}
    model, tr, start = small_trainer(before, [strong], [weak])
    one = tr.run_step()
    one_update = {k: v - start[k] for k, v in
                  __import__("unit_tpu_torch.checkpoint", fromlist=["flax_leaves"])
                  .flax_leaves(model).items()}
    ranks = spawn(tmp_path_factory.mktemp("rdzv"), rank_spatial, before, strong, weak,
                  world=4, timeout=TIMEOUT)
    return {k: float(v) for k, v in metrics.items()}, want, (one, one_update), ranks


@pytest.mark.parametrize("name", [o[0] for o in OPS])
def test_halo_op_on_four_bands_matches_the_whole_op(steps, name):
    *_, ranks = steps
    for r in ranks:
        fwd, grad = r["halo"][name]
        assert fwd <= HALO_REL and grad <= HALO_REL, (name, fwd, grad)


def test_ranks_sit_at_data_and_spatial_coordinates(steps):
    *_, ranks = steps
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 1), (1, 1, 1)]


def test_2d_step_matches_unit_tpus_2x2_mesh_step(steps):
    jax_metrics, want, _, ranks = steps
    metrics, update, _ = ranks[0]["step"]
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    assert worst_update(update, want) <= 1.0
    frozen = [p for p in update if p.startswith(("backbone/stem", "backbone/res2"))]
    assert frozen and all(not update[p].any() for p in frozen)


def test_2d_step_matches_the_one_process_step(steps):
    _, _, (one, one_update), ranks = steps
    metrics, update, _ = ranks[0]["step"]
    for k, v in metrics.items():
        np.testing.assert_allclose(v, one[k], rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    assert worst_update(update, one_update) <= 1.0


def test_2d_ranks_are_bit_identical(steps):
    *_, ranks = steps
    assert len({r["step"][2] for r in ranks}) == 1
    assert all(r["step"][0] == ranks[0]["step"][0] for r in ranks)


def test_remat_under_the_2d_mesh_is_bit_identical(steps):
    *_, ranks = steps
    for r in ranks:
        on, metrics, update = r["remat"]
        assert on and metrics == r["step"][0]
        assert all(np.array_equal(update[k], r["step"][1][k]) for k in update)


def test_2d_refusals_and_the_batch_part(steps):
    *_, ranks = steps
    for r in ranks:
        msg = r["refusals"]
        assert "150 rows" in msg["height"]
        assert "grad accumulation + spatial mesh" in msg["grad_accum"]
        assert "make_train_step" in msg["trainer"] and "shard_batch_spatial" in msg["trainer"]
        part = r["part"]
        assert part["image"] == (2, 80, 224, 3)  # the data rank's 2 images, a band of rows
        assert part["gt_masks"] == (2, 4, 28, 28) and part["gt_boxes"] == (2, 4, 4)


# the map's row bounds over the two bands: uneven below VGG-CNN-F's and
# InceptionResNetV2's unpadded strided ops
BOUNDS = {"vgg_cnn_f": (0, 3, 5), "inception_resnet_v2": (0, 5, 8), "vgg16_dilated": (0, 3, 6)}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_other_backbones_on_two_bands_match_the_whole_backbone(steps, name):
    *_, ranks = steps
    for r in ranks:
        fwd, grad, params, bounds = r["backbones"][name]
        assert max(fwd, grad, params) <= BACKBONE_REL, (name, fwd, grad, params)
        assert bounds == BOUNDS[name]
