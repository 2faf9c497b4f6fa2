"""Pipeline parallelism of unit_tpu_torch against unit_tpu, on the CPU.

unit_tpu's pipeline step is one jitted program over a ("data", "stage")
mesh of the conftest's fake CPU devices; the port's is one process a stage
rank, two here over gloo (the ranks' functions live in the jax-free
tests/test_torch_pipeline_run.py, which also holds the 4-rank cases, the
checkpoints and the run loop).  The same seeded numpy inputs and shared
weights (``load_jax_params``) go through both:

  * the units: ``num_units``, ``_balanced_unit_groups`` at the published
    depths, and a chain of ``backbone_segment`` ranges against unit_tpu's
    ranges and the whole ``backbone_features`` pass;
  * the step: the small flagship in the keep-everything regime at
    TPU.GRAD_ACCUM 2, unit_tpu's ``make_pipeline_train_step`` on a (1, 2)
    mesh (compiled once here) against the port at world 2: the losses to
    rtol 1e-4 and each leaf's update to 2e-3 * max|update_jax| + 1e-9 (the
    bounds of tests/test_torch_parallel.py), both ranks one state; then the
    strong stream alone (TrainerFineTune) and TrainerOnlyWeak under PP,
    finite;
  * the pairing: ``_next_pair`` against unit_tpu's ``_next_stacked_pair``
    on interleaved orientations, the same groups in the same order, and a
    resume that fast-forwards start_step * GRAD_ACCUM batches a stream drops
    the batches the pairing had left waiting, in both packages alike (R18).
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_losses import jax_params
from tests.test_torch_parallel_run import FLAGSHIP, SMALL_OPTS, params_digest, spawn
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from tests.test_torch_pipeline_run import (
    LOSS_RTOL, losses_of, micro_batches, rank_pipeline, worst_update)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.engine.train import TrainerBase as JTrainerBase
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import _balanced_unit_groups as j_groups
from unit_tpu.engine.train import make_pipeline_train_step as jmake_pipeline_train_step
from unit_tpu.models import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.models.resnet import num_units as j_num_units
from unit_tpu.parallel import make_mesh_pp, replicate, shard_batch
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine.train import TrainerBase, _balanced_unit_groups
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models.resnet import num_units


# ------------------------------------------------------------------ the units
@pytest.mark.parametrize("depth", [26, 50, 101, 152])
def test_num_units_and_the_balanced_groups_match(depth):
    n = num_units(depth)
    assert n == j_num_units(depth)
    costs = [0.5] + [1.0] * (n - 1)
    for g in range(1, min(n, 8) + 1):
        groups = _balanced_unit_groups(costs, g)
        assert groups == j_groups(costs, g)
        assert groups[0][0] == 0 and groups[-1][1] == n
        assert all(a < b for a, b in groups)
    if depth == 101:  # unit_tpu's own bar: within a block of the ideal 30.5 / 3
        sums = [sum(costs[a:b]) for a, b in _balanced_unit_groups(costs, 3)]
        assert max(sums) <= 30.5 / 3 + 1.0
    with pytest.raises(ValueError):
        _balanced_unit_groups(costs, n + 1)


def test_unit_ranges_match_unit_tpus_and_chain_to_the_whole_backbone():
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS)
    jcfg = jget_cfg()
    jcfg.merge_from_file(FLAGSHIP)
    jcfg.merge_from_list(SMALL_OPTS)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    rng = np.random.RandomState(0)
    image = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 96, 128, 3)),
                     jnp.asarray([[96.0, 128.0]]))["params"]
    params = jax.tree.map(np.asarray, randomize_params(params, seed=1))
    tm = WSRCNN(ModelConfig.from_cfg(cfg)).eval()
    load_jax_params(tm, params)
    strong = {"image": image[:1]}
    weak = {"image": image[1:]}
    jstrong, jweak = (jax.tree.map(jnp.asarray, b) for b in (strong, weak))
    tstrong, tweak = ({"image": torch.as_tensor(b["image"])} for b in (strong, weak))
    whole_j = np.asarray(jm.apply({"params": params}, strong=jstrong, weak=jweak,
                                  method=JWSRCNN.backbone_features))
    n = num_units(cfg.MODEL.RESNETS.DEPTH)
    scale = float(np.abs(whole_j).max())
    with torch.no_grad():
        whole = tm.backbone_features(tstrong, tweak).numpy()
        assert np.abs(whole - whole_j).max() <= 1e-4 * scale
        for bounds in [(0, n), (0, 2, n), (0, 1, 3, n), (0, 1, 2, 3, n)]:
            x = xj = None
            for st, sp in zip(bounds[:-1], bounds[1:]):
                first = st == 0
                x = tm.backbone_segment(tstrong if first else None, tweak if first else None,
                                        x, st, sp)
                xj = jm.apply({"params": params}, strong=jstrong if first else None,
                              weak=jweak if first else None, feats=xj, start_unit=st,
                              stop_unit=sp, method=JWSRCNN.backbone_segment)
                # each range's map against unit_tpu's, fed unit_tpu's own input
                assert x.shape == xj.shape, bounds
                err = np.abs(x.numpy() - np.asarray(xj)).max()
                assert err <= 1e-4 * max(1.0, float(np.abs(np.asarray(xj)).max())), bounds
            np.testing.assert_array_equal(x.numpy(), whole)  # the chain is the whole pass
        with pytest.raises(ValueError, match="shared strong/weak canvas"):
            tm.backbone_features(tstrong, {"image": torch.zeros(1, 128, 96, 3)})
        with pytest.raises(ValueError, match="need `feats`"):
            tm.backbone_segment(None, None, None, 1, 2)


# ------------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def pipeline_steps(tmp_path_factory):
    """unit_tpu's (1, 2) pipeline step and the port's world-2 ranks."""
    cfg = jget_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS)
    jm, params = jax_params(cfg)
    before = flatten_tree(jax.tree.map(np.asarray, params))
    micro = [micro_batches(31), micro_batches(32)]
    stack = lambda i: {k: jnp.asarray(np.stack([m[i][k] for m in micro]))  # noqa: E731
                       for k in micro[0][i]}
    mesh = make_mesh_pp(1, 2)
    tx = jbuild_optimizer(cfg, params)
    state = replicate(mesh, JTrainState(params=params, opt_state=tx.init(params),
                                        step=jnp.zeros((), jnp.int32)))
    step = jmake_pipeline_train_step(jm, tx, mesh, n_micro=2)
    new_state, metrics = step(state, shard_batch(mesh, stack(0), axis=1),
                              shard_batch(mesh, stack(1), axis=1), None, jax.random.PRNGKey(0))
    after = flatten_tree(jax.tree.map(np.asarray, jax.device_get(new_state.params)))
    want = {k: after[k] - before[k] for k in before}
    ranks = spawn(tmp_path_factory.mktemp("rdzv"), rank_pipeline, before, micro)
    return {k: float(v) for k, v in metrics.items()}, want, ranks


def test_two_stage_step_matches_unit_tpus_pipeline_step(pipeline_steps):
    jax_metrics, want, (a, b) = pipeline_steps
    assert (a["stage"], b["stage"], a["data_rank"], b["data_rank"]) == (0, 1, 0, 0)
    assert losses_of(a["metrics"]) == losses_of(b["metrics"]) and a["digest"] == b["digest"]
    assert set(jax_metrics) == set(losses_of(a["metrics"]))
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
    assert worst_update(a["update"], {p: want[p] for p in a["update"]}) <= 1.0
    frozen = [p for p in a["update"] if p.startswith(("backbone/stem", "backbone/res2"))]
    assert frozen and all(not a["update"][p].any() for p in frozen)
    moved = [p for p in a["update"] if np.abs(want[p]).max() > 0]
    assert any(p.startswith("backbone/res4") for p in moved)  # the first stage trained
    assert any(p.startswith("box_head") for p in moved)  # the last stage trained


def test_strong_only_and_weak_only_streams_run_under_pp(pipeline_steps):
    *_, (a, b) = pipeline_steps
    for name in ("TrainerFineTune", "TrainerOnlyWeak"):
        assert losses_of(a[name]) == losses_of(b[name])
        assert all(np.isfinite(v) for v in a[name].values()), name
    assert "loss_im_cls" not in a["TrainerFineTune"] and "loss_cls" in a["TrainerFineTune"]
    assert "loss_cls" not in a["TrainerOnlyWeak"] and "loss_im_cls" in a["TrainerOnlyWeak"]


# ------------------------------------------------------------------ the pairing
def stream(shapes, tag):
    for i in itertools.count():
        h, w = shapes[i % len(shapes)]
        yield {"image": np.zeros((1, h, w, 3), np.float32), "tag": np.full((1,), tag * 1000 + i)}


SHAPES = {"strong": [(64, 96), (96, 64), (64, 96), (96, 64), (96, 64), (64, 96)],
          "weak": [(96, 64), (96, 64), (64, 96), (64, 96), (64, 96), (96, 64), (96, 64)]}


def port_pairing(strong_iter, weak_iter, a):
    """The port's ``_next_pair`` on its own state (the trainer needs a stage
    mesh; the pairing reads nothing else)."""
    tr = types.SimpleNamespace(_accum_buf={"strong": {}, "weak": {}}, grad_accum=a,
                               strong_iter=strong_iter, weak_iter=weak_iter)
    return lambda: TrainerBase._next_pair(tr)


def jax_pairing(strong_iter, weak_iter, a):
    model = JWSRCNN(mc=JModelConfig())
    tr = JTrainerBase(model, optax.sgd(1e-3), strong_iter=strong_iter, weak_iter=weak_iter,
                      mesh=make_mesh_pp(1, 2), pp=True, grad_accum=a)
    return tr._next_stacked_pair


def groups(pair, n):
    out = []
    for _ in range(n):
        s, w = pair()
        s_tags = [int(b["tag"][0]) for b in s] if isinstance(s, list) else s["tag"][:, 0].tolist()
        w_tags = [int(b["tag"][0]) for b in w] if isinstance(w, list) else w["tag"][:, 0].tolist()
        canvas = (s[0]["image"].shape[1:3] if isinstance(s, list) else s["image"].shape[2:4])
        out.append((tuple(canvas), s_tags, w_tags))
    return out


@pytest.mark.parametrize("a", [2, 3])
def test_next_pair_draws_unit_tpus_groups_in_its_order(a):
    got = groups(port_pairing(stream(SHAPES["strong"], 1), stream(SHAPES["weak"], 2), a), 8)
    want = groups(jax_pairing(stream(SHAPES["strong"], 1), stream(SHAPES["weak"], 2), a), 8)
    assert got == want
    s_seen = [t for _, s, _ in got for t in s]
    assert len(set(s_seen)) == len(s_seen)  # no batch used twice


def test_resume_drops_the_batches_the_pairing_left_waiting_as_unit_tpu_does():
    """R18, kept for parity: ``--resume`` fast-forwards each stream by
    start_step * GRAD_ACCUM batches (unit_tpu runner.py:229-245, the port's
    build_everything), but the joint pairing draws more than that when
    canvases interleave and keeps the rest waiting; the resumed run starts
    from empty buffers, so its next groups are not the uninterrupted run's.
    Both packages do the same."""
    a, k = 2, 3
    for make in (port_pairing, jax_pairing):
        whole = groups(make(stream(SHAPES["strong"], 1), stream(SHAPES["weak"], 2), a), k + 2)
        resumed_streams = (itertools.islice(stream(SHAPES[n], t), k * a, None)
                           for n, t in (("strong", 1), ("weak", 2)))
        resumed = groups(make(*resumed_streams, a), 2)
        assert resumed != whole[k:]
        if make is port_pairing:
            port = (whole, resumed)
    assert port == (whole, resumed)  # unit_tpu's: the same groups, dropped alike
