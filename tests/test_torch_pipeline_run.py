"""Pipeline parallelism of unit_tpu_torch on the CPU: stage ranks over gloo.

This module imports no jax: the ranks import it to find their functions
(``rank_*``, also used by tests/test_torch_pipeline.py, which holds the port
against unit_tpu's pipeline step, and by tests/test_torch_fsdp.py).  Each
multi-rank case spawns its ranks with ``parallel.launch`` as
tests/test_torch_parallel_run.py does (a file rendezvous under
``tmp_path``, a timeout).  Here, in one spawn of four ranks:

  * TPU.PP_STAGES 4 on a (1, 4) mesh (the depth-26 backbone's four units
    in three groups, so every link carries a map of another shape) at
    GRAD_ACCUM 3 against the port's one-process accumulated step on the
    same micro-batches: the losses to rtol 1e-4 and each leaf's update to
    2e-3 * max|update| + 1e-9 (tests/test_torch_parallel.py's bounds), and
    one state on every rank;
  * DP x PP on a (2, 2) mesh at GRAD_ACCUM 2 against one process's update
    from the mean of the two data ranks' accumulated gradients (each
    computed in one process on its half with its seeds), and the losses
    against their mean, within the same bounds (under PP the counts of the
    losses are the data rank's own, as in unit_tpu's step);
  * the (1, 4) step's checkpoint restored by one process, bit for bit, and
    one process's checkpoint restored by the four stage ranks;
  * the (1, 4) step with ``remat=False`` (activations kept, no recompute)
    against the same one-process step, within the same bounds;

and, at world 2, the dock recipe (VGG-CNN-F: a 2-stage split at the
backbone's end, the VGG heads' dropout on the last stage) against its
one-process accumulated step; ``global_normalizer`` inside
``comm.local_counts`` (no collective), the trainer's refusals and the stage
counts unit_tpu allows, and the run loop under TPU.PP at world 2
(``--num-gpus 2 --device cpu``): two steps, a checkpoint and an evaluation
whose AP and merged detections equal a one-process ``--eval-only`` of the
checkpoint.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_run import (
    FLAGSHIP, SMALL_OPTS, TIMEOUT, capture_merged, cli, params_digest, seeded_image_loader,
    spawn, strip_time, update)
from tests.test_torch_parallel_run import devkit  # noqa: F401  (fixture)
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from unit_tpu_torch.parallel import comm

LOSS_RTOL = 1e-4
UPDATE_REL, UPDATE_ATOL = 2e-3, 1e-9
H, W = 96, 128


def micro_batches(seed, b=2):
    """One micro-batch of ``b`` strong and ``b`` weak images on a 96 x 128
    canvas, in the keep-everything regime of ``SMALL_OPTS`` (every anchor
    and proposal is kept, so no draw changes a loss)."""
    rng = np.random.RandomState(seed)
    gtb = np.zeros((b, 3, 4), np.float32)
    gtb[..., :2] = rng.uniform(0, 50, (b, 3, 2))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(25, 45, (b, 3, 2))
    strong = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), gt_boxes=gtb,
                  gt_classes=rng.choice([0, 1, 3, 4], (b, 3)).astype(np.int32),
                  gt_valid=np.asarray([[True, True, i % 2 == 0] for i in range(b)]),
                  image_size=np.asarray([[H, W]] * b, np.float32))
    labels = np.zeros((b, 20), np.float32)
    labels[:, [0, 3]] = 1.0
    weak = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[H, W]] * b, np.float32))
    return strong, weak


def half(batch, d, n):
    """Data rank ``d``'s rows of a global batch split over ``n`` data ranks."""
    rows = len(batch["image"]) // n
    return {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}


def small_model(params=None, *opts):
    """(cfg, the small flagship): unit_tpu's weights ``params`` (flax paths)
    or the port's own, seeded."""
    from unit_tpu_torch.checkpoint import load_jax_params
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.models import WSRCNN, ModelConfig

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS + list(opts))
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(1))
    if params is not None:
        load_jax_params(model, params)
    return cfg, model


def streams(micro, d, n_data, trainer):
    """The trainer's streams: data rank ``d``'s shares of the micro-batches,
    cycled (the strong one alone for TrainerFineTune)."""
    out = {"strong_iter": itertools.cycle([half(s, d, n_data) for s, _ in micro])}
    if trainer != "TrainerFineTune":
        out["weak_iter"] = itertools.cycle([half(w, d, n_data) for _, w in micro])
    return out


def accumulated_trainer(micro, params=None, data_rank=0, n_data=1, trainer="TrainerNoMeta"):
    """(model, one-process trainer at GRAD_ACCUM len(micro), flax leaves) on
    data rank ``data_rank``'s share of each (strong, weak) micro-batch, with
    that rank's seeds."""
    from unit_tpu_torch import engine
    from unit_tpu_torch.checkpoint import flax_leaves
    from unit_tpu_torch.solver import build_optimizer

    cfg, model = small_model(params, "TPU.GRAD_ACCUM", str(len(micro)))
    tr = getattr(engine, trainer)(
        model, build_optimizer(cfg, model), seed=0, grad_accum=len(micro),
        **streams(micro, data_rank, n_data, trainer))
    tr.rank = data_rank
    tr.init_state()
    return model, tr, flax_leaves(model)


def pipeline_trainer(micro, stages, params=None, trainer="TrainerNoMeta", remat=True):
    """(model, the trainer under TPU.PP on the (world / stages, stages) mesh,
    flax leaves), each data rank on its share of each micro-batch; with
    ``remat`` False its step keeps the backbone ranges' activations."""
    from unit_tpu_torch import engine
    from unit_tpu_torch.checkpoint import flax_leaves
    from unit_tpu_torch.engine.train import make_pipeline_train_step
    from unit_tpu_torch.parallel import mesh as mesh_lib
    from unit_tpu_torch.solver import build_optimizer

    cfg, model = small_model(params, "TPU.GRAD_ACCUM", str(len(micro)))
    n_data = comm.world() // stages
    d = comm.rank() // stages
    mesh = mesh_lib.make_mesh_pp(n_data, stages, "cpu")
    tr = getattr(engine, trainer)(
        model, build_optimizer(cfg, model), seed=0, grad_accum=len(micro), mesh=mesh,
        pp=True, **streams(micro, d, n_data, trainer))
    if not remat:
        solver = tr.optimizer
        tr.train_step = make_pipeline_train_step(
            model, solver.optimizer, solver.scheduler, solver.clip, mesh, len(micro),
            tr.train_only_weak, remat=False)
    tr.init_state()
    return model, tr, flax_leaves(model)


def entering_sgd(trainer):
    """{parameter name: the gradient that enters SGD} of ``trainer``'s next
    step (recorded by an optimizer pre-hook; returned empty, filled by the
    step)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    out = {}

    def keep(optimizer, args, kwargs):
        for g in optimizer.param_groups:
            for p in g["params"]:
                out[names[id(p)]] = p.grad.detach().clone()

    trainer.optimizer.optimizer.register_step_pre_hook(keep)
    return out


def apply_gradients(trainer, grads):
    """One update of ``trainer``'s model from ``grads`` (by parameter name),
    as its step applies one: clip, SGD, the schedule."""
    solver = trainer.optimizer
    for name, p in trainer.model.named_parameters():
        if name in grads:
            p.grad = grads[name].clone()
    if solver.clip is not None:
        solver.clip()
    solver.optimizer.step()
    solver.scheduler.step()


# the dock recipe (VGG-CNN-F, the VGG fc heads with dropout) cut to size:
# another backbone than ResNet-C4, so a 2-stage split at its end
DOCK = "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"
DOCK_OPTS = ["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "12", "TPU.COMPUTE_DTYPE", "float32",
             "SOLVER.WARMUP_ITERS", "0"]


def dock_micro_batches(seed, b=1, n=8):
    """One dock micro-batch of ``b`` + ``b`` images on a 96 x 128 canvas with
    ``n`` proposals an image in both streams (no RPN runs then)."""
    rng = np.random.RandomState(seed)

    def props():
        xy = rng.uniform(0, [W - 40, H - 40], (b, n, 2))
        return (np.concatenate([xy, xy + rng.uniform(12, 40, (b, n, 2))], -1).astype(np.float32),
                np.ones((b, n), bool))

    gtb = np.zeros((b, 3, 4), np.float32)
    gtb[..., :2] = rng.uniform(0, 50, (b, 3, 2))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(25, 45, (b, 3, 2))
    strong = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), gt_boxes=gtb,
                  gt_classes=rng.choice([0, 1, 2, 7], (b, 3)).astype(np.int32),
                  gt_valid=np.ones((b, 3), bool), image_size=np.asarray([[H, W]] * b, np.float32))
    labels = np.zeros((b, 80), np.float32)
    labels[:, [0, 7]] = 1.0
    weak = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[H, W]] * b, np.float32))
    strong["proposals"], strong["proposals_valid"] = props()
    weak["proposals"], weak["proposals_valid"] = props()
    return strong, weak


def dock_trainer(micro, pp):
    """(model, the dock trainer at GRAD_ACCUM len(micro), flax leaves):
    under PP on the (1, 2) stage mesh, or in one process."""
    from unit_tpu_torch.checkpoint import flax_leaves
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.parallel import mesh as mesh_lib
    from unit_tpu_torch.solver import build_optimizer

    cfg = get_cfg()
    cfg.merge_from_file(DOCK)
    cfg.merge_from_list(DOCK_OPTS)
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(2))
    tr = TrainerNoMeta(model, build_optimizer(cfg, model), seed=0, grad_accum=len(micro),
                       mesh=mesh_lib.make_mesh_pp(1, 2, "cpu") if pp else None, pp=pp,
                       **streams(micro, 0, 1, "TrainerNoMeta"))
    tr.init_state()
    return model, tr, flax_leaves(model)


# ------------------------------------------------------------------ the ranks
def rank_dock(device, micro):
    """The dock recipe under PP at world 2: one step's metrics and update."""
    model, tr, before = dock_trainer(micro, pp=True)
    return tr.run_step(), update(model, before), tr._stage


def rank_pipeline(device, params, micro):
    """At world 2, one stage a rank: (b) one pipelined step from ``params``
    (metrics, update, the stage and the final digest); (g) one step each of
    TrainerFineTune (the strong stream alone) and TrainerOnlyWeak under PP
    (their losses)."""
    out = {}
    model, tr, before = pipeline_trainer(micro, 2, params)
    out["stage"], out["data_rank"] = tr._stage, tr.rank
    out["metrics"] = tr.run_step()
    out["update"], out["digest"] = update(model, before), params_digest(model)
    for name in ("TrainerFineTune", "TrainerOnlyWeak"):
        _, tr, _ = pipeline_trainer(micro, 2, params, trainer=name)
        out[name] = tr.run_step()
    return out


def rank_four(device, micro3, micro2, ckpt_dir, one_ckpt):
    """At world 4: (1, 4) at GRAD_ACCUM 3 (metrics, update, digest; its
    checkpoint written to ``ckpt_dir``, then ``one_ckpt`` restored: the
    digest), the same step without remat (metrics, update), then (2, 2) at
    GRAD_ACCUM 2 (metrics, update)."""
    from unit_tpu_torch.checkpoint import Checkpointer

    out = {}
    model, tr, before = pipeline_trainer(micro3, 4)
    out["stage"] = tr._stage
    out["metrics4"] = tr.run_step()
    out["update4"], out["digest4"] = update(model, before), params_digest(model)
    Checkpointer(ckpt_dir).save(int(tr.state.step), tr.state, wait=True)
    Checkpointer(os.path.dirname(one_ckpt)).restore(state=tr.state)
    out["restored"] = params_digest(model), tr.state.step
    model, tr, before = pipeline_trainer(micro3, 4, remat=False)
    out["metrics4_plain"], out["update4_plain"] = tr.run_step(), update(model, before)
    model, tr, before = pipeline_trainer(micro2, 2)
    out["metrics22"], out["update22"] = tr.run_step(), update(model, before)
    out["rank"], out["data_rank"] = comm.rank(), tr.rank
    return out


def rank_builds(device, kwargs):
    """A TrainerBase(**kwargs) on a (1, world) stage mesh: its stage, whether
    it is the last, its data rank and the data ranks its losses average over."""
    from unit_tpu_torch.engine import TrainerBase
    from unit_tpu_torch.parallel import mesh as mesh_lib
    from unit_tpu_torch.solver import build_optimizer

    cfg, model = small_model(None, "MODEL.RESNETS.RES2_OUT_CHANNELS", "16")
    mesh = mesh_lib.make_mesh_pp(1, comm.world(), "cpu")
    tr = TrainerBase(model, build_optimizer(cfg, model), mesh=mesh, **kwargs)
    return tr._stage, tr._last_stage, tr.rank, tr._loss_ranks


# ------------------------------------------------------------------ tests
def worst_update(got, want):
    return max(np.abs(got[p] - want[p]).max() / (UPDATE_REL * np.abs(want[p]).max()
                                                 + UPDATE_ATOL) for p in want)


def losses_of(metrics):
    """The losses of a step's metrics (without the rank's own data wait)."""
    return {k: v for k, v in metrics.items() if k != "data_time"}


def assert_losses(got, want):
    for k, v in want.items():
        if k != "data_time":
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The one-process references and the one spawn of four ranks."""
    from unit_tpu_torch.checkpoint import Checkpointer

    micro3 = [micro_batches(s, b=1) for s in (11, 12, 13)]
    micro2 = [micro_batches(s, b=2) for s in (21, 22)]
    model, tr, before = accumulated_trainer(micro3)
    one3 = (tr.run_step(), update(model, before), params_digest(model))
    one_dir = tmp_path_factory.mktemp("one_ckpt")
    Checkpointer(str(one_dir)).save(1, tr.state, wait=True)
    halves = []
    for d in (0, 1):  # each data rank's accumulated gradient, then their mean applied
        _, tr, _ = accumulated_trainer(micro2, data_rank=d, n_data=2)
        grads = entering_sgd(tr)
        halves.append((tr.run_step(), grads))
    model, tr, before = accumulated_trainer(micro2)
    (m0, g0), (m1, g1) = halves
    apply_gradients(tr, {n: (g0[n] + g1[n]) / 2 for n in g0})
    halves = ({k: (m0[k] + m1[k]) / 2 for k in losses_of(m0)}, update(model, before))
    ckpt = tmp_path_factory.mktemp("pp_ckpt")
    ranks = spawn(tmp_path_factory.mktemp("rdzv"), rank_four, micro3, micro2, str(ckpt),
                  str(one_dir / "step_1.pt"), world=4, timeout=2 * TIMEOUT)
    return one3, halves, ranks, str(ckpt / "step_1.pt")


def test_four_stages_match_the_accumulated_step(four_ranks):
    (metrics, want, digest), _, ranks, _ = four_ranks
    assert [r["stage"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert losses_of(r["metrics4"]) == losses_of(ranks[0]["metrics4"])
        assert r["digest4"] == ranks[0]["digest4"]
    assert_losses(ranks[0]["metrics4"], metrics)
    assert worst_update(ranks[0]["update4"], want) <= 1.0
    moved = [p for p in want if np.abs(want[p]).max() > 0]
    assert any(p.startswith("backbone/res3") for p in moved)  # the middle stages trained


def test_four_stages_without_remat_match_the_accumulated_step(four_ranks):
    """``remat=False``: the backbone ranges keep their activations for
    backward instead of recomputing them; the same update as one process's."""
    (metrics, want, _), _, ranks, _ = four_ranks
    for r in ranks:
        assert losses_of(r["metrics4_plain"]) == losses_of(ranks[0]["metrics4_plain"])
    assert_losses(ranks[0]["metrics4_plain"], metrics)
    assert worst_update(ranks[0]["update4_plain"], want) <= 1.0


def test_data_x_stage_matches_the_data_ranks_accumulated_steps(four_ranks):
    _, (metrics, want), ranks, _ = four_ranks
    assert [r["data_rank"] for r in ranks] == [0, 0, 1, 1]
    for r in ranks:
        assert losses_of(r["metrics22"]) == losses_of(ranks[0]["metrics22"])
    assert worst_update(ranks[0]["update22"], want) <= 1.0
    assert_losses(ranks[0]["metrics22"], metrics)


def test_pipeline_checkpoints_move_to_one_process_and_back(four_ranks):
    from unit_tpu_torch.checkpoint import Checkpointer

    (_, _, one_digest), _, ranks, path = four_ranks
    _, tr, _ = accumulated_trainer([micro_batches(11, b=1)] * 3)
    Checkpointer(os.path.dirname(path)).restore(state=tr.state)
    assert params_digest(tr.model) == ranks[0]["digest4"] and tr.state.step == 1
    for r in ranks:  # one process's checkpoint, restored by every stage rank
        assert r["restored"] == (one_digest, 1)


def test_the_dock_recipe_splits_at_its_backbone_with_dropout_on_the_last_stage(tmp_path):
    """Another backbone than ResNet-C4 (VGG-CNN-F) splits at its end
    (``backbone_features``); the VGG heads drop units with the step's own
    dropout generators on the last stage: the pipelined step equals the
    one-process accumulated step on the same micro-batches."""
    micro = [dock_micro_batches(s) for s in (41, 42)]
    model, tr, before = dock_trainer(micro, pp=False)
    assert tr.dropout  # the VGG heads' dropout runs in this step
    metrics, want = tr.run_step(), update(model, before)
    (ma, ua, sa), (mb, _, sb) = spawn(tmp_path, rank_dock, micro)
    assert (sa, sb) == (0, 1) and losses_of(ma) == losses_of(mb)
    assert_losses(ma, metrics)
    assert worst_update(ua, want) <= 1.0


def test_stage_counts_outside_the_units_refuse():
    """unit_tpu's assertion (train.py:292-295): 2 .. num_units + 1 stages for
    ResNet-C4 (depth 26: 5), exactly 2 for another backbone."""
    import types

    from unit_tpu_torch.engine import make_pipeline_train_step
    from unit_tpu_torch.solver import build_optimizer

    def mesh(stages):
        return types.SimpleNamespace(mesh_dim_names=("data", "stage"),
                                     size=lambda dim: (1, stages)[dim])

    cfg, model = small_model(None, "MODEL.RESNETS.RES2_OUT_CHANNELS", "16")
    solver = build_optimizer(cfg, model)
    args = (model, solver.optimizer, solver.scheduler, solver.clip)
    with pytest.raises(ValueError, match=r"must be in \[2, 5\] for this backbone, got 6"):
        make_pipeline_train_step(*args, mesh(6), 2)
    with pytest.raises(ValueError, match="GRAD_ACCUM >= 2"):
        make_pipeline_train_step(*args, mesh(2), 1)
    _, dock = dock_trainer([dock_micro_batches(1)] * 2, pp=False)[:2]
    solver = dock.optimizer
    with pytest.raises(ValueError, match=r"must be in \[2, 2\] for this backbone, got 3"):
        make_pipeline_train_step(dock.model, solver.optimizer, solver.scheduler, solver.clip,
                                 mesh(3), 2)


def test_global_normalizer_makes_no_collective_under_pp(monkeypatch):
    import torch.distributed as dist

    def no_collective(*a, **kw):
        raise AssertionError("a collective was made")

    monkeypatch.setattr(comm, "world", lambda: 2)
    monkeypatch.setattr(dist, "all_reduce", no_collective)
    with comm.local_counts():
        assert float(comm.global_normalizer(torch.tensor(3.0))) == 3.0
        assert float(comm.global_normalizer(torch.tensor(0.0))) == 1.0
    with pytest.raises(AssertionError, match="collective"):
        comm.global_normalizer(torch.tensor(3.0))


def test_trainer_under_pp_refuses_as_unit_tpu_does():
    """unit_tpu's refusals in its order (train.py:613-624), then its pipeline
    step's assert of a stage axis (train.py:274); building on a stage mesh
    is tests/test_torch_fsdp.py::test_sharding_knob_validation's."""
    from unit_tpu_torch.engine import TrainerBase, make_pipeline_train_step
    from unit_tpu_torch.solver import build_optimizer

    cfg, model = small_model(None, "MODEL.RESNETS.RES2_OUT_CHANNELS", "16")
    solver = build_optimizer(cfg, model)
    with pytest.raises(ValueError, match="FSDP/TP"):
        TrainerBase(model, solver, pp=True, grad_accum=1, fsdp=True)
    with pytest.raises(ValueError, match="GRAD_ACCUM >= 2"):
        TrainerBase(model, solver, pp=True, grad_accum=1, meta_iter=iter(()))
    with pytest.raises(ValueError, match="meta stream"):
        TrainerBase(model, solver, pp=True, grad_accum=2, meta_iter=iter(()))
    with pytest.raises(ValueError, match="'stage' mesh axis"):
        TrainerBase(model, solver, pp=True, grad_accum=2)
    with pytest.raises(ValueError, match="'stage' mesh axis"):
        make_pipeline_train_step(model, solver.optimizer, solver.scheduler, solver.clip,
                                 None, 2)


# ------------------------------------------------------------------ the run loop
def rank_pp_run(device, args):
    """One rank of the run loop under PP: its evaluations' results, the
    merged evaluators, the final digest and its stage."""
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner, train

    states, stages = [], []
    module, name, merge = capture_merged(states)
    setattr(module, name, merge)
    real = train.TrainerBase.init_state

    def init_state(self):
        stages.append(self._stage)
        return real(self)

    train.TrainerBase.init_state = init_state
    DatasetCatalog.clear()
    final = runner.run(args, image_loader=seeded_image_loader)
    return {"final": final, "states": states, "stage": stages}


def test_run_loop_under_pp_at_world_two(devkit, tmp_path_factory, monkeypatch):  # noqa: F811
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner

    out = tmp_path_factory.mktemp("pp_run")
    pp = ["TPU.PP", "True", "TPU.GRAD_ACCUM", "2"]
    args = cli(devkit, out)
    args.opts += pp + ["SOLVER.MAX_ITER", "2"]
    a, b = spawn(tmp_path_factory.mktemp("rdzv"), rank_pp_run, args, timeout=TIMEOUT)
    assert (a["stage"], b["stage"]) == ([0], [1])
    assert {"step_2.pt", "metrics.json"} <= set(os.listdir(out))
    assert strip_time(a["final"]) == strip_time(b["final"])
    assert len(a["states"]) == 2 and a["states"] == b["states"]  # at 2, final
    # one process evaluates the step-2 checkpoint: the same GT, detections and AP
    states = []
    monkeypatch.setattr(*capture_merged(states))
    DatasetCatalog.clear()
    alone = runner.run(cli(devkit, out, "--eval-only", "--resume"),
                       image_loader=seeded_image_loader)
    (dets, gt), = states
    assert (dets, gt) == a["states"][-1] and sum(map(len, dets.values())) > 0
    gathered = a["final"]["bbox"]
    for k in ("AP", "AP50", "AP75", "novel_mean"):
        assert np.isfinite(alone["bbox"][k]) and abs(gathered[k] - alone["bbox"][k]) <= 1e-6, k
