"""FSDP and tensor parallelism of unit_tpu_torch on the CPU: ranks over gloo.

This module imports no jax: the ranks import it to find their functions
(``rank_*``, also used by tests/test_torch_fsdp.py and tests/test_torch_tp.py,
which hold the port against unit_tpu).  Each multi-rank case spawns its
ranks with ``parallel.launch`` as tests/test_torch_parallel_run.py does (a
file rendezvous under ``tmp_path``, a timeout).  Here:

  * the two TP collectives (``parallel.tensor``) at world 2: a
    column-parallel convolution, dense layer and transposed convolution
    against the whole layer, forward and every gradient, and the mesh's
    groups and ranks at world 4 (rank r at (r // 2, r % 2));
  * the loaders' shard and batch at world 4 under TP 2: the two model ranks
    of a data rank read the same records, the two data ranks different ones,
    and the test loaders every rank its own;
  * FSDP at world 1 (a one-rank mesh and ``fully_shard``) bit-identical to
    the plain step;
  * checkpoints across topologies: a step-2 checkpoint written under FSDP
    at world 2 and one under TP 2 each restored by one process (parameters
    and momentum bit-identical to the gathered state), one process's
    restored under FSDP and under TP at world 2 (each rank's parts equal the
    file's slices), and the resumed runs' next steps within the bounds of
    an uninterrupted run;
  * ``train_net_torch.py``'s runner with ``--num-gpus 2 --device cpu`` under
    TPU.FSDP and under TPU.TP 2 (with PreciseBN): two steps, a checkpoint and
    an evaluation on a synthetic devkit, and the log's line of what was split.
"""

import functools
import hashlib
import itertools
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_run import FLAGSHIP, SMALL_OPTS, TINY, cli, spawn
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from unit_tpu_torch.parallel import comm, launch
from unit_tpu_torch.parallel import mesh as mesh_lib

TIMEOUT = 150  # seconds: the group's collectives and the join
FSDP_LEAF = "backbone.res4.block0.conv2.weight"  # large enough to shard at the small size


# ------------------------------------------------------------- rank helpers
def data_share(batch, n_model=1, global_rank=False):
    """This data rank's rows of a global batch (the ``n_model`` model ranks
    of a data rank get the same rows); ``global_rank``: the rows of this
    rank's GLOBAL rank out of the data world (what the data rank replaces)."""
    world = comm.data_world(n_model)
    n = len(batch["image"]) // world
    r = comm.rank() % world if global_rank else comm.data_rank(n_model)
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def split_mesh(mode: str, n_model: int = 1):
    """The mesh of ``mode`` ("fsdp", "tp" or "plain") over this group, on the CPU."""
    if mode == "fsdp":
        return mesh_lib.make_mesh(comm.world(), "cpu")
    if mode == "tp":
        return mesh_lib.make_mesh_tp(comm.world() // n_model, n_model, "cpu")
    return None


def split_model(model, mode: str, n_model: int = 1):
    """(model split as ``mode`` says, its mesh)."""
    mesh = split_mesh(mode, n_model)
    if mode == "fsdp":
        mesh_lib.fsdp_shard(model, mesh)
    elif mode == "tp":
        mesh_lib.tp_shard(model, mesh)
    return model, mesh


def full_flax_leaves(model):
    """{flax path: whole f32 array in the flax layout} of every parameter
    (a collective on a split model)."""
    from unit_tpu_torch.checkpoint.jax_params import flax_path, to_flax_layout

    full = mesh_lib.full_state_dict(model)
    return {flax_path(n, p): np.array(to_flax_layout(full[n].float().cpu().numpy(), n),
                                      copy=True)
            for n, p in model.named_parameters()}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def sharded_trainer(params, strong_batches, weak_batches, mode, n_model=1, *opts,
                    global_rank=False):
    """(model, TrainerNoMeta, whole flax leaves) of the small flagship from
    ``params`` (flax paths), split as ``mode`` says, on this data rank's
    share of each global batch of ``strong_batches`` and ``weak_batches``
    (taken once the mesh says which data rank this is).  ``global_rank``:
    the share and the step's seed read the global rank instead."""
    from unit_tpu_torch.checkpoint import load_jax_params
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.solver import build_optimizer

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS + list(opts))
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, params)
    model, mesh = split_model(model, mode, n_model)
    tr = TrainerNoMeta(model, build_optimizer(cfg, model),
                       itertools.cycle([data_share(b, n_model, global_rank)
                                        for b in strong_batches]),
                       itertools.cycle([data_share(b, n_model, global_rank)
                                        for b in weak_batches]),
                       seed=0, grad_accum=cfg.TPU.GRAD_ACCUM, mesh=mesh, fsdp=mode == "fsdp",
                       tp=mode == "tp")
    if global_rank:
        tr.rank = comm.rank()
    tr.init_state()
    return model, tr, full_flax_leaves(model)


def split_record(model):
    """{name: (local shape, whole shape, torch dim split)} of the split
    parameters."""
    from torch.distributed.tensor import DTensor

    out = {}
    for n, p in model.named_parameters():
        if isinstance(p, DTensor):
            out[n] = (tuple(p.to_local().shape), tuple(p.shape), p.placements[0].dim)
        elif hasattr(p, "tp_shard"):
            out[n] = (tuple(p.shape), mesh_lib.full_shape(p), p.tp_shard[0])
    return out


def rank_sharded(device, mode, n_model, params, strong, weak, global_rank=False, steps=3,
                 opts=()):
    """The small flagship from ``params``, split as ``mode`` says, on this
    data rank's share of a global batch: the first update (whole leaves),
    ``steps`` steps' metrics, the digests of the whole state and of the
    parameters no mode split, and what was split.  ``global_rank``: the
    share and the step's seed read the GLOBAL rank (``sharded_trainer``)."""
    model, tr, before = sharded_trainer(params, [strong], [weak], mode, n_model, *opts,
                                        global_rank=global_rank)
    tr.train(1)
    after = full_flax_leaves(model)
    out = {"update": {k: v - before[k] for k, v in after.items()},
           "split": split_record(model),
           "data": (comm.data_rank(n_model), comm.data_world(n_model))}
    tr.train(steps)
    out["metrics"] = tr.metrics_history
    out["digest"] = digest(sorted(mesh_lib.full_state_dict(model).items()))
    out["whole_digest"] = digest((n, p) for n, p in model.named_parameters()
                                 if not comm.is_split(p))
    return out


def rank_accumulate_sharded(device, mode, n_model, params, micro_strong, micro_weak):
    """One step at TPU.GRAD_ACCUM 2 over this data rank's share of two global
    micro-batches, split as ``mode`` says: its metrics and update."""
    model, tr, before = sharded_trainer(params, micro_strong, micro_weak, mode, n_model,
                                        "TPU.GRAD_ACCUM", "2")
    metrics = tr.run_step()
    return metrics, {k: v - before[k] for k, v in full_flax_leaves(model).items()}


def rank_fsdp(device, params, strong, weak, micro_strong, micro_weak):
    """FSDP at this world: ``rank_sharded``'s 3 steps, a step at
    TPU.GRAD_ACCUM 2, and the trainer's wiring, checked on a 4-step run
    with TPU.REMAT_BACKBONE on (its metrics: FSDP's all-gathers run again
    in the recompute)."""
    from torch.distributed.fsdp import FSDPModule

    from unit_tpu_torch.checkpoint import load_jax_params
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.solver import build_optimizer

    out = {"run": rank_sharded(device, "fsdp", 1, params, strong, weak),
           "accum": rank_accumulate_sharded(device, "fsdp", 1, params, micro_strong,
                                            micro_weak)}
    model, tr, _ = sharded_trainer(params, [strong], [weak], "fsdp", 1,
                                   "TPU.REMAT_BACKBONE", "True")
    tr.train(4)
    out["remat"] = (model.mc.remat_backbone, tr.metrics_history)
    leaf = model.get_parameter(FSDP_LEAF)
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS)
    whole = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(whole, params)
    try:
        TrainerNoMeta(whole, build_optimizer(cfg, whole), mesh=tr.mesh, fsdp=True)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    out["wiring"] = {"mesh": tr.mesh.mesh_dim_names, "fsdp_root": isinstance(model, FSDPModule),
                     "step": tr.state.step, "leaf_type": type(leaf).__name__,
                     "leaf_local": leaf.to_local().numel(), "leaf_numel": leaf.numel(),
                     "refusal": refusal}
    return out


def rank_tp(device, params, strong, weak, global_rank_case):
    """TP 2 at this world: ``rank_sharded``'s 3 steps and, with
    ``global_rank_case``, one step whose seed and share read the global rank
    (its metrics and update)."""
    out = {"run": rank_sharded(device, "tp", 2, params, strong, weak)}
    if global_rank_case:
        run = rank_sharded(device, "tp", 2, params, strong, weak, global_rank=True, steps=1)
        out["global_rank"] = (run["metrics"][0], run["update"])
    return out


# ------------------------------------------------------------ TP collectives
def rank_column_parallel(device):
    """Each column-parallel layer against the whole layer on the same
    inputs: the output, the input gradient and the (whole) weight and bias
    gradients."""
    from unit_tpu_torch.models.box_heads import Linear
    from unit_tpu_torch.models.mask_head import Deconv2d
    from unit_tpu_torch.models.resnet import Conv2d
    from unit_tpu_torch.parallel.tensor import COLUMN_PARALLEL

    mesh = mesh_lib.make_mesh_tp(1, comm.world(), "cpu")
    group = mesh.get_group("model")
    g = torch.Generator().manual_seed(0)
    cases = {"conv": (Conv2d(6, 8, 3, padding=1, bias=True, generator=g),
                      torch.randn(2, 6, 5, 7, generator=g).contiguous(
                          memory_format=torch.channels_last)),
             "linear": (Linear(6, 8, generator=g), torch.randn(3, 6, generator=g)),
             "deconv": (Deconv2d(6, 8), torch.randn(2, 6, 4, 5, generator=g).contiguous(
                 memory_format=torch.channels_last))}
    out = {"mesh": mesh.mesh_dim_names}
    for name, (layer, x) in cases.items():
        torch.nn.init.normal_(layer.weight, generator=g)  # the same on every rank
        torch.nn.init.normal_(layer.bias, generator=g)
        split = COLUMN_PARALLEL[type(layer)](layer, group)
        cot = torch.randn(layer(x).shape, generator=g)
        res = []
        for m in (layer, split):
            xi = x.clone().requires_grad_(True)
            y = m(xi)
            (y * cot).sum().backward()
            res.append(tuple(t.numpy() for t in (
                y.detach(), xi.grad, mesh_lib.full_tensor(m.weight.grad, m.weight),
                mesh_lib.full_tensor(m.bias.grad, m.bias))) + (
                    y.is_contiguous(memory_format=torch.channels_last) if y.dim() == 4 else True,))
        out[name] = res + [tuple(split.weight.shape), split.weight.tp_shard]
    return out


def test_column_parallel_layers_equal_the_whole_layer(tmp_path):
    a, b = spawn(tmp_path, rank_column_parallel)
    assert a["mesh"] == ("data", "model")
    for name, local_shape, dim in (("conv", (4, 6, 3, 3), 0), ("linear", (4, 6), 0),
                                   ("deconv", (6, 4, 2, 2), 1)):
        for r, out in enumerate((a, b)):
            whole, split, shape, shard = out[name]
            assert shape == local_shape and shard == (dim, r, 2), name
            for w, s in zip(whole[:4], split[:4]):
                # f32: another split of the same sums (1e-5 of the largest value)
                np.testing.assert_allclose(s, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                           err_msg=name)
            assert split[4] == whole[4], name  # a channels_last map stays channels_last


def rank_groups(device, records):
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data.loader import (
        _host_shard, _model_ranks, _per_host_batch, _sync_portrait_frac)

    mesh = mesh_lib.make_mesh_tp(2, 2, "cpu")
    cfg = get_cfg()
    cfg.merge_from_list(["TPU.TP", "2"])
    m = _model_ranks(cfg)
    out = {"data": (comm.data_rank(m), comm.data_world(m)),
           "mesh": (tuple(mesh.get_coordinate()), mesh.get_local_rank("data"),
                    mesh.get_local_rank("model"), tuple(mesh.shape)),
           "shard": [r["image_id"] for r in _host_shard(records, m)],
           "frac": _sync_portrait_frac(records, m), "batch": _per_host_batch(8, m),
           "normalizer": float(comm.global_normalizer(torch.tensor(3.0 + comm.data_rank(m)))),
           # the test loaders' shard: every rank its own (whole replicas evaluate)
           "test_shard": [r["image_id"] for r in _host_shard(records)]}
    try:
        comm.data_world(3)
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def test_mesh_groups_and_loader_shards_follow_the_data_rank(tmp_path):
    records = [{"image_id": f"im{i}", "height": 90 + 30 * (i % 3 == 0), "width": 100}
               for i in range(9)]
    ranks = spawn(tmp_path, rank_groups, records, world=4)
    for r, out in enumerate(ranks):
        assert out["data"] == (r // 2, 2)
        assert out["mesh"] == ((r // 2, r % 2), r // 2, r % 2, (2, 2))
        assert out["shard"] == [f"im{i}" for i in range(r // 2, 9, 2)]
        assert out["frac"] == 3 / 9 and out["batch"] == 4
        # (3 + 3 + 4 + 4) / 4 over the world: the data ranks' (3 + 4) / 2
        assert out["normalizer"] == 3.5
        assert out["test_shard"] == [f"im{i}" for i in range(r, 9, 4)]
        assert "not divisible by TPU.TP=3" in out["refusal"]


# ------------------------------------------------------- FSDP at world one
def rank_fsdp_world_one(device, params, strong, weak):
    """The plain step and the FSDP step of a one-rank mesh, 2 steps each:
    the whole parameters' digests and the metrics."""
    out = {}
    for mode in ("plain", "fsdp"):
        model, tr, _ = sharded_trainer(params, [strong], [weak], mode)
        tr.train(2)
        out[mode] = (digest(sorted(mesh_lib.full_state_dict(model).items())),
                     tr.metrics_history, type(model).__name__)
    return out


@pytest.fixture(scope="module")
def small_params():
    return seeded_params()


def seeded_params(seed: int = 4):
    """The small flagship's parameters (flax paths), from a seeded port model."""
    from unit_tpu_torch.checkpoint import flax_leaves
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.models import WSRCNN, ModelConfig

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS)
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(seed))
    tree = {}
    for path, v in flax_leaves(model).items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    for name, b in model.named_buffers():  # FrozenBN statistics and the embeddings
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = b.numpy()
    return tree


def small_batches(seed=1, b=2):
    """A strong and a weak batch of ``b`` images for the small flagship."""
    rng = np.random.RandomState(seed)
    h, w, g = 96, 128, 4
    gtb = np.zeros((b, g, 4), np.float32)
    gtb[..., 0] = rng.uniform(0, w - 50, (b, g))
    gtb[..., 1] = rng.uniform(0, h - 50, (b, g))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(20, 45, (b, g, 2))
    strong = dict(image=rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32), gt_boxes=gtb,
                  gt_classes=rng.randint(0, 15, (b, g)).astype(np.int32),
                  gt_valid=np.asarray([[True, True, True, False]] * b),
                  image_size=np.asarray([[h, w]] * b, np.float32))
    labels = np.zeros((b, 20), np.float32)
    labels[:, [0, 3]] = 1.0
    weak = dict(image=rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[h, w]] * b, np.float32))
    return strong, weak


def test_fsdp_at_world_one_is_the_plain_step(tmp_path, small_params):
    strong, weak = small_batches()
    (out,) = spawn(tmp_path, rank_fsdp_world_one, small_params, strong, weak, world=1,
                   timeout=TIMEOUT)
    assert out["fsdp"][2].startswith("FSDP")  # really split, over one rank
    assert out["fsdp"][0] == out["plain"][0]
    for a, b in zip(out["fsdp"][1], out["plain"][1]):
        assert {k: v for k, v in a.items() if k != "data_time"} == \
            {k: v for k, v in b.items() if k != "data_time"}


# -------------------------------------------------- checkpoints across topologies
def payload_arrays(payload):
    """Copies of a checkpoint payload's model tensors and momenta, as numpy
    arrays (the payload's whole tensors may be the live ones)."""
    return ({k: v.numpy().copy() for k, v in payload["model"].items()},
            {int(i): st["momentum_buffer"].numpy().copy()
             for i, st in payload["optimizer"]["state"].items()})


def rank_topology(device, mode, params, strong, weak, out_dir, one_dir):
    """Under ``mode`` at this world: (a) 2 steps, a checkpoint in ``out_dir``,
    the gathered state, the 3rd step's metrics; (b) a fresh split model
    restored from ``one_dir``'s checkpoint (one process's): whether each
    rank's parts of the parameters and momenta equal the file's slices, and
    the next step's metrics."""
    from torch.distributed.tensor import DTensor

    from unit_tpu_torch.checkpoint import Checkpointer, read_checkpoint
    from unit_tpu_torch.checkpoint.checkpointer import state_payload

    n_model = 2 if mode == "tp" else 1
    model, tr, _ = sharded_trainer(params, [strong], [weak], mode, n_model)
    tr.train(2)
    Checkpointer(out_dir).save(2, tr.state)
    saved = payload_arrays(state_payload(tr.state))
    tr.train(3)
    out = {"saved": saved if comm.is_main() else None, "metrics3": tr.metrics_history[-1]}

    model, tr, _ = sharded_trainer(params, [strong], [weak], mode, n_model)
    Checkpointer(one_dir).restore(state=tr.state)
    file = read_checkpoint(os.path.join(one_dir, "step_2.pt"))
    opt = tr.state.solver.optimizer
    params_in_order = [p for group in opt.param_groups for p in group["params"]]
    equal = tr.state.step == 2
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        local = t.to_local() if isinstance(t, DTensor) else t
        equal &= torch.equal(local.detach(), mesh_lib.local_part(file["model"][name], t))
    for i, p in enumerate(params_in_order):
        buf = opt.state[p]["momentum_buffer"]
        buf = buf.to_local() if isinstance(buf, DTensor) else buf
        equal &= torch.equal(buf, mesh_lib.local_part(
            file["optimizer"]["state"][i]["momentum_buffer"], p))
    out["split"] = len(split_record(model))
    tr.train(3)
    out["restored"] = (bool(equal), tr.metrics_history[-1])
    return out


def one_process_trainer(params, strong, weak):
    model, tr, _ = sharded_trainer(params, [strong], [weak], "plain")
    return model, tr


@pytest.fixture(scope="module")
def topologies(tmp_path_factory, small_params):
    """One process's run (2 steps, a checkpoint, a 3rd step), then FSDP and
    TP at world 2 (``rank_topology``), each restoring that checkpoint."""
    s0, w0 = small_batches(1)
    s1, w1 = small_batches(2)
    strong = {k: np.concatenate([s0[k], s1[k]]) for k in s0}
    weak = {k: np.concatenate([w0[k], w1[k]]) for k in w0}
    from unit_tpu_torch.checkpoint import Checkpointer

    one_dir = tmp_path_factory.mktemp("one")
    _, tr = one_process_trainer(small_params, strong, weak)
    tr.train(2)
    Checkpointer(str(one_dir)).save(2, tr.state)
    tr.train(3)
    runs = {"one": tr.metrics_history[-1]}
    for mode in ("fsdp", "tp"):
        out_dir = tmp_path_factory.mktemp(mode)
        ranks = spawn(tmp_path_factory.mktemp("rdzv"), rank_topology, mode, small_params,
                      strong, weak, str(out_dir), str(one_dir), timeout=TIMEOUT)
        runs[mode] = (out_dir, ranks)
    return small_params, strong, weak, runs


def close_losses(got, want, rtol=1e-4):
    for k, v in want.items():
        if k != "data_time":
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_a_world_two_checkpoint_restores_in_one_process(topologies, mode):
    from unit_tpu_torch.checkpoint import Checkpointer
    from unit_tpu_torch.checkpoint.checkpointer import state_payload

    params, strong, weak, runs = topologies
    out_dir, (a, b) = runs[mode]
    assert a["split"] > 0
    assert a["metrics3"]["total_loss"] == b["metrics3"]["total_loss"]
    model, tr = one_process_trainer(params, strong, weak)
    Checkpointer(str(out_dir)).restore(state=tr.state)
    got_model, got_momentum = payload_arrays(state_payload(tr.state))
    want_model, want_momentum = a["saved"]
    assert got_model.keys() == want_model.keys() and got_momentum.keys() == want_momentum.keys()
    for k, v in want_model.items():
        np.testing.assert_array_equal(got_model[k], v, err_msg=k)
    for k, v in want_momentum.items():
        np.testing.assert_array_equal(got_momentum[k], v, err_msg=str(k))
    tr.train(3)
    close_losses(tr.metrics_history[-1], a["metrics3"])  # as the run that went on


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_a_one_process_checkpoint_restores_at_world_two(topologies, mode):
    *_, runs = topologies
    _, ranks = runs[mode]
    for out in ranks:
        equal, metrics = out["restored"]
        assert equal  # each rank's parts are the file's slices, bit for bit
        close_losses(metrics, runs["one"])  # as the one-process run that went on


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    from tests.test_torch_data import write_devkit
    from tests.test_torch_parallel_run import DEVKIT_SIZES

    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"), sizes=DEVKIT_SIZES)


@pytest.mark.parametrize("opts,split", [
    pytest.param(["TPU.FSDP", "True"], "FSDP over the ('data',) mesh", id="fsdp"),
    # with PreciseBN before the evaluation, on the whole replica
    pytest.param(["TPU.TP", "2", "TEST.PRECISE_BN.ENABLED", "True",
                  "TEST.PRECISE_BN.NUM_ITER", "2"], "TP over the ('data', 'model') mesh",
                 id="tp")])
def test_train_net_at_world_two_trains_and_evaluates(devkit, tmp_path, monkeypatch, opts, split):
    from tests.test_torch_parallel_run import seeded_image_loader
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner

    DatasetCatalog.clear()
    monkeypatch.setattr(runner, "launch", functools.partial(launch, timeout=TIMEOUT))
    args = cli(devkit, tmp_path, "--num-gpus", "2")
    # res4 at 256 channels: the TP rule has kernels to split
    args.opts += ["MODEL.RESNETS.RES2_OUT_CHANNELS", "64", "SOLVER.MAX_ITER", "2", *opts]
    results = runner.run(args, image_loader=seeded_image_loader)
    assert np.isfinite(results["bbox"]["AP50"])
    assert {"step_2.pt", "best_info.json"} <= set(os.listdir(tmp_path))
    log = (tmp_path / "log.txt").read_text()
    line = next(ln for ln in log.splitlines() if split in ln)
    assert int(line.split(": ")[-1].split(" of ")[0]) > 0, line
    assert ("PreciseBN: refreshed" in log) == ("TEST.PRECISE_BN.ENABLED" in opts)
    assert TINY  # the tiny recipe of tests/test_torch_parallel_run.py
