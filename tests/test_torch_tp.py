"""Tensor parallelism of unit_tpu_torch against unit_tpu's, on the CPU.

unit_tpu's TP is its jitted step over a (data, model) mesh with the state
placed by ``tp_sharding`` (``make_mesh_tp``, the conftest's fake CPU
devices): GSPMD splits the >= 256-channel kernels' outputs over "model" and
places the collectives.  The port's is one gloo rank a mesh position with
the column-parallel layers of ``parallel.tensor`` (``parallel.mesh.tp_shard``;
the ranks' functions live in the jax-free tests/test_torch_sharded_run.py).
The same seeded numpy inputs go through both, with
tests/test_torch_parallel.py's small flagship and global batch of 4 + 4
images, weights carried across by ``load_jax_params``; the losses to rtol
1e-4 and each leaf's update to 2e-3 * max|update_jax| + 1e-9:

  * TP 2 at world 2 (data 1 x model 2) against ``make_mesh_tp(1, 2)``;
  * TP 2 at world 4 (data 2 x model 2) against ``make_mesh_tp(2, 2)``: the
    case a seed, a loader shard or a normaliser that read the GLOBAL rank
    would break.  The same run with the step's seed and the batch's share
    taken by the global rank misses the bounds: the two model ranks of a
    data rank then hold different images, and the all-gathers glue channel
    slices of different images together while the step still runs.  (The
    seed alone moves little here: in this keep-everything regime the
    samplers keep every anchor and proposal.);
  * the kernels the port splits are those unit_tpu's ``tp_sharding``
    splits (the 2-D ``embeddings`` leaf aside: a whole buffer in the port);
  * after 3 steps the parameters no mode splits are bit-identical on every
    rank, and so are the ranks' gathered states.
"""

import numpy as np
import pytest

from tests.test_torch_fsdp import flax_name, jax_mesh_step, sharded_paths
from tests.test_torch_parallel import LOSS_RTOL, global_batch, worst_loss, worst_update
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from tests.test_torch_parallel_run import spawn
from tests.test_torch_sharded_run import TIMEOUT, rank_tp
from unit_tpu.parallel.mesh import MODEL_AXIS, make_mesh_tp, tp_sharding


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """unit_tpu's TP steps on (1, 2) and (2, 2) meshes and the port's at world
    2 and at world 4 (with the global-rank case), one spawn each."""
    strong, weak = global_batch(1)
    two = jax_mesh_step(make_mesh_tp(1, 2), tp_sharding, strong, weak)
    four = jax_mesh_step(make_mesh_tp(2, 2), tp_sharding, strong, weak)
    rdzv = tmp_path_factory.mktemp("rdzv")
    before = two[2]
    ranks2 = spawn(rdzv, rank_tp, before, strong, weak, False, world=2, timeout=TIMEOUT)
    ranks4 = spawn(rdzv, rank_tp, before, strong, weak, True, world=4, timeout=TIMEOUT)
    return {2: (two, ranks2), 4: (four, ranks4)}


def assert_matches(jax_run, ranks):
    jax_metrics, want, _, _ = jax_run
    first = ranks[0]["run"]["metrics"][0]
    assert all(r["run"]["metrics"][0][k] == first[k] for r in ranks for k in jax_metrics)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(first[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert worst_update(ranks[0]["run"]["update"], want) <= 1.0


def test_tp_world_two_matches_unit_tpus_one_by_two_mesh(tp):
    jax_run, ranks = tp[2]
    assert [r["run"]["data"] for r in ranks] == [(0, 1), (0, 1)]
    assert_matches(jax_run, ranks)


def test_tp_world_four_matches_unit_tpus_two_by_two_mesh(tp):
    jax_run, ranks = tp[4]
    assert [r["run"]["data"] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert_matches(jax_run, ranks)


def test_a_global_rank_misses_the_bounds(tp):
    (jax_metrics, want, _, _), ranks = tp[4]
    metrics, update = ranks[0]["global_rank"]
    loss_off = worst_loss(metrics, jax_metrics)
    update_off = worst_update(update, want)
    print(f"global-rank seed and share: losses off by {loss_off:.3g} (rtol {LOSS_RTOL}), "
          f"updates at {update_off:.3g} x the bound")
    assert loss_off > LOSS_RTOL or update_off > 1.0


@pytest.mark.parametrize("world", [2, 4])
def test_tp_splits_the_kernels_unit_tpu_splits(tp, world):
    (_, _, _, shardings), ranks = tp[world]
    want = sharded_paths(shardings, MODEL_AXIS)
    # the GloVe table is a frozen buffer in the port, whole on every rank
    assert want.pop("embeddings") == 1
    # torch dim -> flax dim: OIHW -> HWIO (the deconv's IOHW -> HWIO), [out, in] -> [in, out]
    for r in ranks:
        split = r["run"]["split"]
        kernels = {flax_name(n, len(full)): len(full) - 1
                   for n, (local, full, dim) in split.items() if n.endswith("weight")}
        assert kernels == want and len(kernels) == 7  # res4's, both Res5 heads', the RPN's
        for n, (local, full, dim) in split.items():  # half the output channels a rank
            assert local[dim] * 2 == full[dim], n
        assert all(n[:-len("bias")] + "weight" in split for n in split if n.endswith("bias"))


@pytest.mark.parametrize("world", [2, 4])
def test_tp_ranks_agree_after_three_steps(tp, world):
    _, ranks = tp[world]
    assert all(len(r["run"]["metrics"]) == 3 for r in ranks)
    assert len({r["run"]["whole_digest"] for r in ranks}) == 1  # the replicated parameters
    assert len({r["run"]["digest"] for r in ranks}) == 1
    assert len({tuple(m["total_loss"] for m in r["run"]["metrics"]) for r in ranks}) == 1
