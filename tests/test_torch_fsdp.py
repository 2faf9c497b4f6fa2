"""FSDP of unit_tpu_torch against unit_tpu's, on the CPU.

unit_tpu's FSDP is its jitted mesh step with the state placed by
``fsdp_sharding`` (``make_train_step(mesh=make_mesh(2), state_sharding=...)``
on the conftest's fake CPU devices); the port's is FSDP2's ``fully_shard``
over two gloo ranks (``parallel.mesh.fsdp_shard``; the ranks' functions live
in the jax-free tests/test_torch_sharded_run.py).  The same seeded numpy
inputs go through both, with tests/test_torch_parallel.py's small flagship
and global batch of 4 + 4 images, weights carried across by
``load_jax_params``:

  * the step: the losses to rtol 1e-4 and each leaf's update to
    2e-3 * max|update_jax| + 1e-9 (tests/test_torch_parallel.py's bounds);
  * the split: the leaves the port shards, and on which dim, are those
    unit_tpu's ``fsdp_sharding`` shards, and res4's 3x3 conv holds half
    its elements on each rank;
  * after 3 steps the ranks' gathered states are bit-identical;
  * ``TPU.GRAD_ACCUM`` 2 at world 2 (the reduce-scatter waits for the last
    micro-batch) against one process at GRAD_ACCUM 2 on the global
    micro-batches;
  * TPU.REMAT_BACKBONE under FSDP: 3 steps bit-identical to the key off;
  * the trainer's wiring (``TrainerNoMeta(mesh=..., fsdp=True)``, as
    tests/test_parallel.py::test_trainer_fsdp_knob holds unit_tpu's) and
    the refusals of unit_tpu's trainer (tests/test_pipeline.py
    ::test_pipeline_knob_validation), as ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_losses import jax_params
from tests.test_torch_parallel import LOSS_RTOL, global_batch, jax_cfg, worst_update
from tests.test_torch_parallel_run import FLAGSHIP, SMALL_OPTS, spawn
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from tests.test_torch_pipeline_run import rank_builds
from tests.test_torch_sharded_run import FSDP_LEAF, TIMEOUT, rank_fsdp
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import make_train_step as jmake_train_step
from unit_tpu.parallel import make_mesh, shard_batch
from unit_tpu.parallel.mesh import DATA_AXIS, fsdp_sharding
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine import TrainerBase, TrainerNoMeta
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer


def flax_name(name: str, ndim: int) -> str:
    """The flax path of a torch parameter name of a tensor of ``ndim`` dims."""
    parts = name.split(".")
    if parts[-1] == "weight" and ndim in (2, 4):
        parts[-1] = "kernel"
    return "/".join(parts)


def sharded_paths(shardings, axis):
    """{flax path: flax dim split over ``axis``} of a NamedSharding tree."""
    out = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            shardings, is_leaf=lambda s: hasattr(s, "spec")):
        spec = tuple(sh.spec)
        if axis in spec:
            out["/".join(str(k.key) for k in path)] = spec.index(axis)
    return out


def jax_mesh_step(mesh, sharding_fn, strong, weak):
    """unit_tpu's step on ``mesh`` with its state placed by ``sharding_fn``:
    (metrics, update, params before, the params' sharding tree)."""
    cfg = jax_cfg()
    jm, params = jax_params(cfg)
    before = flatten_tree(jax.tree.map(np.asarray, params))
    tx = jbuild_optimizer(cfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    sh = sharding_fn(mesh, state)
    state = jax.tree.map(jax.device_put, state, sh)
    new_state, metrics = jmake_train_step(jm, tx, mesh=mesh, state_sharding=sh)(
        state, shard_batch(mesh, strong), shard_batch(mesh, weak), None, jax.random.PRNGKey(0))
    after = flatten_tree(jax.tree.map(np.asarray, jax.device_get(new_state.params)))
    return ({k: float(v) for k, v in metrics.items()}, {k: after[k] - before[k] for k in before},
            before, sh.params)


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    """unit_tpu's FSDP step at 2 devices and the port's at world 2 (one spawn:
    3 steps, then a step at GRAD_ACCUM 2, then the wiring checks)."""
    strong, weak = global_batch(1)
    metrics, want, before, shardings = jax_mesh_step(make_mesh(2), fsdp_sharding, strong, weak)
    micro = [global_batch(3), global_batch(5)]
    ranks = spawn(tmp_path_factory.mktemp("rdzv"), rank_fsdp, before, strong, weak,
                  [s for s, _ in micro], [w for _, w in micro], timeout=TIMEOUT)
    return metrics, want, before, shardings, micro, ranks


def test_fsdp_world_two_step_matches_unit_tpus_fsdp_step(fsdp):
    jax_metrics, want, _, _, _, (a, b) = fsdp
    run = a["run"]
    assert all(run["metrics"][0][k] == b["run"]["metrics"][0][k] for k in jax_metrics)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(run["metrics"][0][k], v, rtol=LOSS_RTOL, err_msg=k)
    assert worst_update(run["update"], want) <= 1.0
    frozen = [p for p in run["update"] if p.startswith(("backbone/stem", "backbone/res2"))]
    assert frozen and all(not run["update"][p].any() for p in frozen)


def test_fsdp_shards_the_leaves_unit_tpu_shards(fsdp):
    *_, shardings, _, (a, b) = fsdp
    want = sharded_paths(shardings, DATA_AXIS)
    # the GloVe table is a frozen buffer in the port, whole on every rank
    assert want.pop("embeddings") == 1
    # torch dim -> flax dim: OIHW -> HWIO, [out, in] -> [in, out]
    to_flax = {4: [3, 2, 0, 1], 2: [1, 0], 1: [0]}
    for out in (a, b):
        got = {flax_name(n, len(full)): to_flax[len(full)][dim]
               for n, (local, full, dim) in out["run"]["split"].items()}
        assert got == want
    local, full, _ = a["run"]["split"][FSDP_LEAF]
    assert int(np.prod(local)) * 2 == int(np.prod(full))  # half of res4's 3x3 conv a rank


def test_fsdp_ranks_are_bit_identical_after_three_steps(fsdp):
    *_, (a, b) = fsdp
    assert len(a["run"]["metrics"]) == 3 and a["run"]["digest"] == b["run"]["digest"]
    assert [m["total_loss"] for m in a["run"]["metrics"]] == \
        [m["total_loss"] for m in b["run"]["metrics"]]


def test_fsdp_accumulation_at_world_two_equals_one_process(fsdp):
    _, _, before, _, micro, (a, b) = fsdp
    from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS + ["TPU.GRAD_ACCUM", "2"])
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, before)
    start = flax_leaves(model)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), iter([s for s, _ in micro]),
                            iter([w for _, w in micro]), seed=0, grad_accum=2)
    trainer.init_state()
    metrics = trainer.run_step()
    want = {k: v - start[k] for k, v in flax_leaves(model).items()}
    got_metrics, got = a["accum"]
    for k, v in metrics.items():
        if k != "data_time":
            np.testing.assert_allclose(got_metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert worst_update(got, want) <= 1.0
    assert b["accum"][0]["total_loss"] == got_metrics["total_loss"]


def test_trainer_fsdp_knob(fsdp):
    """TPU.FSDP wiring through TrainerBase: the trainer keeps the mesh, the
    large leaf stays sharded over both ranks after the updates, the step
    count and the losses are those of the steps taken, and a model that was
    not split is refused (its solver would hold whole parameters)."""
    *_, (a, b) = fsdp
    for out in (a, b):
        wiring = out["wiring"]
        assert wiring["mesh"] == ("data",) and wiring["fsdp_root"]
        assert wiring["step"] == 4 and wiring["leaf_type"] == "DTensor"
        assert wiring["leaf_local"] * 2 == wiring["leaf_numel"]
        assert "fsdp_shard" in wiring["refusal"]
        assert all(np.isfinite(v) for m in out["run"]["metrics"] for v in m.values())


def test_fsdp_with_remat_is_bit_identical(fsdp):
    """TPU.REMAT_BACKBONE under FSDP at world 2: the recompute runs the
    blocks' all-gathers again in backward, in one order on both ranks; the
    first 3 steps' losses equal those of the run with the key off, bit for
    bit."""
    *_, (a, b) = fsdp
    for out in (a, b):
        on, metrics = out["remat"]
        assert on and len(metrics) == 4
        for got, want in zip(metrics, out["run"]["metrics"], strict=False):
            assert {k: v for k, v in got.items() if k != "data_time"} == \
                {k: v for k, v in want.items() if k != "data_time"}


def small_model():
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16"])
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    return model, build_optimizer(cfg, model)


def test_sharding_knob_validation(tmp_path):
    """unit_tpu's refusals (train.py:613-624), in its order; pipeline
    parallelism (ported since) builds on a stage mesh, and without one
    refuses as unit_tpu's pipeline step asserts (train.py:274)."""
    model, opt = small_model()
    with pytest.raises(ValueError, match="mutually exclusive"):
        TrainerBase(model, opt, fsdp=True, tp=True)
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        TrainerBase(model, opt, pp=True, grad_accum=1)
    with pytest.raises(ValueError, match="FSDP/TP"):
        TrainerBase(model, opt, pp=True, grad_accum=2, fsdp=True)
    with pytest.raises(ValueError, match="FSDP/TP"):
        TrainerBase(model, opt, pp=True, grad_accum=2, tp=True)
    with pytest.raises(ValueError, match="meta stream"):
        TrainerBase(model, opt, pp=True, grad_accum=2, meta_iter=iter(()))
    with pytest.raises(ValueError, match="'stage' mesh axis"):
        TrainerBase(model, opt, pp=True, grad_accum=2)
    # on a (1, 2) stage mesh: rank 0 the first stage, rank 1 the last, one data rank
    assert spawn(tmp_path, rank_builds, {"pp": True, "grad_accum": 2}) == [
        (0, False, 0, 1), (1, True, 0, 1)]
    # without a mesh, fsdp and tp are ignored, as in unit_tpu: the plain trainer
    for kwargs in ({"fsdp": True}, {"tp": True}):
        assert TrainerBase(model, opt, **kwargs).mesh is None
