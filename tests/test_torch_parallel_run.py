"""Data parallelism of unit_tpu_torch on the CPU: two ranks over gloo.

Every multi-rank case spawns its ranks with ``parallel.launch`` (rendezvous
through a file under ``tmp_path``, never a TCP port, so concurrent test
workers cannot collide) and bounds them with a timeout: the process group's
own and the join's, past which the ranks are killed and the test fails.

This module imports no jax: the ranks import it to find their functions
(``rank_*``, also used by tests/test_torch_parallel.py, which holds the
port against unit_tpu).  Here:

  * the collectives of ``parallel.comm`` at world 2 and in one process, and
    ``host_group`` (the gloo group for the deferred losses' all-reduce where
    the default backend is not gloo);
  * ``launch``'s refusals, a failing rank and a hanging rank;
  * ``_host_shard`` and ``_per_host_batch`` with rank and world taken from
    an initialised group, and the refusal of an indivisible batch;
  * the run loop at world 2 on a synthetic devkit (``--device cpu``, gloo):
    4 steps with a checkpoint and an evaluation at 2 and 4; only rank 0
    writes files (an audit hook in each rank records every file it opens
    for writing, renames, removes or creates under OUTPUT_DIR); the gathered
    evaluator holds exactly the GT and detections of a one-process
    ``--eval-only`` of the step-4 checkpoint, and its AP equals that run's
    to 1e-6 (a random R-26 finds no object: the AP is 0, so the detections
    are what the comparison rests on);
    ``--num-gpus 2 --resume`` from step 2 (the runner's own spawn) ends with
    a step-4 checkpoint bit-identical to the uninterrupted run's;
  * a stop requested on rank 1 alone, with the losses resolved 8 steps
    late (``metrics_pipeline_depth``), stops both ranks on the same step,
    within the depth of the request, with the same losses (in the run
    loop's spawn);
  * ``--num-gpus`` above the cards present raises, naming both counts.
"""

import functools
import hashlib
import itertools
import os
import shutil
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from unit_tpu_torch.parallel import comm, launch

TIMEOUT = 120  # seconds: the group's collectives and the join
FLAGSHIP = "configs/VOC/VOC-RCNN-101-C4-split1.yaml"


@pytest.fixture(scope="module", autouse=True)
def four_threads():
    """Four torch threads here, so two in each of two CPU ranks (``launch``
    splits this process's threads): bit-identical comparisons between
    spawns need one thread count, and six test workers on eight cores
    oversubscribe the machine at torch's default."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def spawn(tmp_path, main, *args, world=2, timeout=TIMEOUT):
    """``main(device, *args)`` on ``world`` CPU ranks over gloo."""
    return launch(main, world, ["cpu"] * world, "gloo",
                  init_method=f"file://{tmp_path}/rendezvous-{time.monotonic_ns()}",
                  args=args, timeout=timeout)


def params_digest(model) -> str:
    """A hash of every parameter and buffer, bit for bit."""
    h = hashlib.sha256()
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ collectives
def rank_comm(device):
    import torch.distributed as dist

    r, w = comm.rank(), comm.world()
    out = {"rank": r, "world": w, "is_main": comm.is_main(), "device": str(device),
           "backend": dist.get_backend()}
    comm.barrier()
    out["sum"] = comm.all_reduce_sum(torch.tensor([1.0, float(r)])).tolist()
    out["mean"] = comm.all_reduce_mean(torch.tensor([2.0 * (r + 1)])).tolist()
    tensors = [torch.full((3,), float(r)), torch.full((2, 2), 10.0 * r),
               torch.tensor([r], dtype=torch.float64)]
    comm.all_reduce_mean_tensors(tensors)
    out["mean_tensors"] = [t.tolist() for t in tensors]
    out["gather"] = comm.gather_objects({"rank": r, "x": np.arange(r + 1)})
    # rank r counts 3 + r valid slots: the divisor averages to the global count
    out["normalizer"] = float(comm.global_normalizer(torch.tensor(3.0 + r)))
    module = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(module.weight, float(r + 1))
    module.register_buffer("steps", torch.tensor([7 * (r + 1)], dtype=torch.int64))
    comm.broadcast_module(module)
    out["broadcast"] = (module.weight.tolist(), module.steps.tolist())
    out["host_group"] = host_group_of_another_backend(dist)
    return out


def host_group_of_another_backend(dist):
    """``comm.host_group`` under gloo (None: the default group) and as it
    goes where the default backend is not gloo (the backend's name patched):
    a gloo group of the world, made once, that sums host tensors."""
    default = comm.host_group()
    real = dist.get_backend
    dist.get_backend = lambda group=None: "nccl"
    try:
        group = comm.host_group()
        again = comm.host_group() is group
    finally:
        dist.get_backend = real
    total = comm.all_reduce_sum(torch.tensor([1.0, float(comm.rank())]), group).tolist()
    return default, dist.get_backend(group), dist.get_world_size(group), again, total


def test_collectives_at_world_two(tmp_path):
    a, b = spawn(tmp_path, rank_comm)
    assert (a["rank"], a["world"], a["is_main"]) == (0, 2, True)
    assert (b["rank"], b["world"], b["is_main"]) == (1, 2, False)
    for out in (a, b):
        assert out["backend"] == "gloo" and out["device"] == "cpu"
        assert out["sum"] == [2.0, 1.0] and out["mean"] == [3.0]
        assert out["mean_tensors"] == [[0.5] * 3, [[5.0, 5.0], [5.0, 5.0]], [0.5]]
        assert [g["rank"] for g in out["gather"]] == [0, 1]
        assert [g["x"].tolist() for g in out["gather"]] == [[0], [0, 1]]
        assert out["normalizer"] == 3.5  # (3 + 4) / 2: the rank means sum to the global loss
        assert out["broadcast"] == ([[1.0] * 3] * 2, [7])  # rank 0's state everywhere
        assert out["host_group"] == (None, "gloo", 2, True, [2.0, 1.0])


def test_collectives_in_one_process_are_the_identity():
    assert (comm.rank(), comm.world(), comm.is_main()) == (0, 1, True)
    comm.barrier()
    t = torch.tensor([1.5, 2.0])
    assert comm.all_reduce_sum(t) is t and comm.all_reduce_mean(t) is t
    assert t.tolist() == [1.5, 2.0]
    obj = {"x": np.arange(3)}
    (back,) = comm.gather_objects(obj)
    assert back is obj
    # one rank: the count itself, at least 1, as the losses divided before
    assert float(comm.global_normalizer(torch.tensor(0.0))) == 1.0
    assert float(comm.global_normalizer(torch.tensor(5.0))) == 5.0


def rank_fails(device):
    if comm.rank() == 1:
        raise ValueError("rank one fails on purpose")
    comm.barrier()  # waits for a peer that never comes: killed by launch
    return "unreachable"


def rank_hangs(device):
    time.sleep(600)


def test_launch_refuses_and_reports_failures(tmp_path):
    with pytest.raises(ValueError, match="2 ranks need 2 devices"):
        launch(rank_comm, 2, ["cpu"], "gloo")
    with pytest.raises(ValueError, match="gloo"):
        launch(rank_comm, 2, ["cpu", "cpu"], "nccl")
    with pytest.raises(ValueError, match="cards"):
        launch(rank_comm, 2, [0, 0], "gloo")  # no card here
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        spawn(tmp_path, rank_fails)
    with pytest.raises(TimeoutError, match="did not finish in 15"):
        spawn(tmp_path, rank_hangs, timeout=15)
    assert time.monotonic() - t0 < 2 * TIMEOUT


# ------------------------------------------------------------------ loaders
def rank_shard(device, records):
    from unit_tpu_torch.data.loader import _host_shard, _per_host_batch, _sync_portrait_frac

    out = {"shard": [r["image_id"] for r in _host_shard(records)],
           "frac": _sync_portrait_frac(records), "batch": _per_host_batch(8)}
    try:
        _per_host_batch(3)
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def test_host_shard_and_per_host_batch_follow_the_group(tmp_path):
    records = [{"image_id": f"im{i}", "height": 90 + 30 * (i % 3 == 0), "width": 100}
               for i in range(9)]
    a, b = spawn(tmp_path, rank_shard, records)
    assert a["shard"] == [f"im{i}" for i in range(0, 9, 2)]
    assert b["shard"] == [f"im{i}" for i in range(1, 9, 2)]
    assert a["frac"] == b["frac"] == 3 / 9  # the whole list's, before the shard
    assert a["batch"] == b["batch"] == 4
    assert "IMS_PER_BATCH=3 is not divisible by the 2 ranks" in a["refusal"]


# ------------------------------------------------- the ranks of test_torch_parallel.py
# the small flagship in the keep-everything regime (tests/test_torch_losses.py
# ::small_train_cfg; WARMUP_ITERS 0 as tests/test_torch_train.py::trainer_cfg)
SMALL_OPTS = [
    "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "600", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128",
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "TPU.COMPUTE_DTYPE", "float32", "SOLVER.WARMUP_ITERS", "0",
]


def share(batch):
    """This rank's rows of a global batch (rank r: the r-th 1/world)."""
    n = len(batch["image"]) // comm.world()
    r = comm.rank()
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def small_trainer(params, strong_batches, weak_batches, *opts):
    """(model, TrainerNoMeta over the batches, the parameters' flax leaves)
    of the small flagship from ``params`` (flax paths)."""
    from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.solver import build_optimizer

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS + list(opts))
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, params)
    tr = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.cycle(strong_batches),
                       itertools.cycle(weak_batches), seed=0, grad_accum=cfg.TPU.GRAD_ACCUM)
    tr.init_state()
    return model, tr, flax_leaves(model)


def update(model, before):
    """Each parameter's change since ``before`` (flax leaves)."""
    from unit_tpu_torch.checkpoint import flax_leaves

    return {k: v - before[k] for k, v in flax_leaves(model).items()}


def rank_train(device, params, strong, weak):
    """The small flagship from ``params`` on this rank's share of a global
    batch: (a) one step with a rank-local valid-slot count in the fast R-CNN
    loss (what the global normaliser replaces), recording this rank's
    counts; (b) 3 steps with the port's own losses: the metrics, the first
    update and the final parameters' digest."""
    from unit_tpu_torch.models import fast_rcnn

    trainer = functools.partial(small_trainer, params)
    out = {"counts": []}
    real = fast_rcnn.global_normalizer

    def local(count):
        out["counts"].append(float(count))
        return count.detach().float().clamp_min(1.0)

    fast_rcnn.global_normalizer = local
    try:
        model, tr, before = trainer([share(strong)], [share(weak)])
        out["local"] = (tr.run_step(), update(model, before))
    finally:
        fast_rcnn.global_normalizer = real
    model, tr, before = trainer([share(strong)], [share(weak)])
    tr.train(1)
    out["update"] = update(model, before)
    tr.train(3)
    out["metrics"], out["digest"] = tr.metrics_history, params_digest(model)
    return out


def rank_accumulate(device, params, micro_strong, micro_weak):
    """One step of the small flagship at TPU.GRAD_ACCUM 2 over this rank's
    share of two global micro-batches: its metrics and update."""
    model, tr, before = small_trainer(params, [share(b) for b in micro_strong],
                                      [share(b) for b in micro_weak], "TPU.GRAD_ACCUM", "2")
    return tr.run_step(), update(model, before)


def rank_losses(device, frcnn, mask, attention):
    """The batch-spanning losses on this rank's share of their inputs: each
    loss and the gradient of their sum w.r.t. this rank's inputs (the rank
    losses read their pooled maps detached: w.r.t. the head's parameters)."""
    from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
    from unit_tpu_torch.models import fast_rcnn, mask_head
    from unit_tpu_torch.models.visual_attention import VisualAttentionHead
    from unit_tpu_torch.structures.instances import SampledProposals

    def mine(a):
        n = len(a) // comm.world()
        return torch.as_tensor(np.array(a[comm.rank() * n:(comm.rank() + 1) * n]))

    out = {}
    scores, deltas = (mine(frcnn[k]).requires_grad_(True) for k in ("scores", "deltas"))
    fields = {k: mine(v).long() if v.dtype == np.int32 else mine(v)
              for k, v in frcnn["fields"].items()}
    losses = fast_rcnn.fast_rcnn_losses(scores, deltas, SampledProposals(**fields),
                                        fast_rcnn.FastRCNNConfig(num_classes=frcnn["classes"]))
    sum(losses.values()).backward()
    out["frcnn"] = ({k: float(v.detach()) for k, v in losses.items()}, scores.grad.numpy(),
                    deltas.grad.numpy())
    logits = mine(mask["logits"]).requires_grad_(True)
    loss = mask_head.mask_rcnn_loss(logits, *(mine(mask[k]) for k in (
        "classes", "masks", "gt", "roi", "fg")))
    loss.backward()
    out["mask"] = (float(loss.detach()), logits.grad.numpy())
    head = VisualAttentionHead(attention["num_classes"], depth=26, res2_out_channels=64,
                               mode="mean", roi_align_impl="plain")
    load_jax_params(head, attention["params"])
    att = head.support_prototypes(*(torch.as_tensor(attention[k])
                                    for k in ("feats", "boxes", "valid")), attention["base"])
    losses = head.rank_loss(mine(attention["pooled"]), mine(attention["gt"]),
                            mine(attention["qvalid"]), att, attention["base"])
    sum(losses.values()).backward()
    out["rank"] = ({k: float(v.detach()) for k, v in losses.items()},
                   flax_leaves(head, grads=True))
    return out


def tiny_world_trainer():
    """A tiny flagship trainer of this rank in a group, on its own images."""
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.solver import build_optimizer

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                         "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200",
                         "MODEL.RPN.POST_NMS_TOPK_TRAIN", "16",
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
                         "TPU.COMPUTE_DTYPE", "float32"])
    # rank r's own weights: the trainer starts every rank from rank 0's
    model = WSRCNN(ModelConfig.from_cfg(cfg),
                   generator=torch.Generator().manual_seed(comm.rank()))
    rng = np.random.RandomState(comm.rank())
    strong = dict(image=rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32),
                  image_size=np.asarray([[64, 96]], np.float32),
                  gt_boxes=np.asarray([[[10, 8, 50, 40], [30, 20, 90, 60]]], np.float32),
                  gt_classes=np.asarray([[0, 3]], np.int32),
                  gt_valid=np.asarray([[True, comm.rank() == 0]]))
    labels = np.zeros((1, 20), np.float32)
    labels[0, [0, 3 + comm.rank()]] = 1.0
    weak = dict(image=rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[64, 96]], np.float32))
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.repeat(strong),
                            itertools.repeat(weak), seed=1)
    trainer.init_state()
    return trainer


def rank_tiny_trainer(device):
    """A tiny flagship trainer at world 2, each rank on its own images, 2 steps:
    the world, the global losses and the parameters' digest."""
    trainer = tiny_world_trainer()
    trainer.train(2)
    return {"world": trainer.world, "digest": params_digest(trainer.model),
            "losses": [m["total_loss"] for m in trainer.metrics_history]}


class StopOnRankOne:
    """A hook that takes lazy metrics and asks rank 1 alone to stop at ``step``."""

    takes_lazy_metrics = True

    def __init__(self, step):
        self.step = step

    def __call__(self, step, metrics, trainer):
        if comm.rank() == 1 and step == self.step:
            trainer.request_stop()


STOP_AT, STOP_DEPTH = 3, 8


def stop_at_depth(depth=STOP_DEPTH, at=STOP_AT, max_iter=12):
    """The tiny trainer at ``depth`` with a stop requested on rank 1 after
    step ``at``: (the step it stopped at, whether it saw the request, the
    global total losses)."""
    trainer = tiny_world_trainer()
    trainer.metrics_pipeline_depth = depth
    trainer.train(max_iter, hooks=[StopOnRankOne(at)])
    return (trainer.state.step, trainer.stop_requested,
            [m["total_loss"] for m in trainer.metrics_history])


def voc_feed(ev, image_ids):
    """GT and detections of ``image_ids`` into a VOC evaluator (either package's),
    made from each id alone: the same in any order and any process."""
    for img in image_ids:
        rng = np.random.RandomState(int(img[1:]))
        ev.process_gt_record({"image_id": img, "annotations": [
            {"category_id": 0, "bbox": [10, 10, 50, 50]},
            {"category_id": 1, "bbox": [60, 60, 90, 90]},
            {"category_id": int(rng.randint(2)), "bbox": [20, 30, 70, 80], "difficult": 1}]})
        ev.process(img, np.asarray([[10, 10, 50, 50], [60, 60, 90, 90], [15, 30, 70, 85]],
                                   np.float64) + rng.rand(3, 4) * 8,
                   rng.rand(3), np.asarray([0, 1, int(rng.randint(2))]), np.ones(3, bool))


def coco_feed(ev, image_ids):
    """GT and detections of ``image_ids`` into a COCO box evaluator."""
    for img in image_ids:
        rng = np.random.RandomState(int(img[1:]))
        ev.process_gt_record({"image_id": img, "height": 100, "width": 100, "annotations": [
            {"category_id": 0, "bbox": [10, 10, 40, 40]},
            {"category_id": 1, "bbox": [50, 40, 30, 45]}]})
        ev.process(img, np.asarray([[11, 11, 49, 49], [50, 40, 80, 85], [5, 5, 30, 30]])
                   + rng.rand(3, 4) * 6, rng.rand(3), np.asarray([0, 1, 0]), np.ones(3, bool))


def rank_evaluate(device, image_ids, classes):
    """VOC and COCO evaluators fed this rank's half of ``image_ids``, merged
    over the ranks (``merge_gathered``) and scored."""
    from unit_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from unit_tpu_torch.evaluation.evaluator import merge_gathered
    from unit_tpu_torch.evaluation.voc_eval import PascalVOCEvaluator

    mine = image_ids[comm.rank()::comm.world()]
    voc, coco = PascalVOCEvaluator(classes, use_07_metric=False), COCOEvaluator(classes)
    voc_feed(voc, mine)
    coco_feed(coco, mine)
    return merge_gathered(voc).evaluate(), merge_gathered(coco).evaluate()


LOADER_OPTS = [
    "DATASETS.TRAIN", "('voc_base_training_query_train',)",
    "DATASETS.TEST", "('voc_base_training_query_val',)",
    "DATASETS.CLASSIFIER_TRAIN", "('pascal_trainval_2007', 'pascal_trainval_2012')",
    "SOLVER.IMS_PER_BATCH", "4", "INPUT.MIN_SIZE_TRAIN", "(96, 128)",
    "INPUT.MAX_SIZE_TRAIN", "160", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
    "TEST.AUG.MIN_SIZES", "(64, 96)", "TEST.AUG.MAX_SIZE", "160",
    "TPU.MAX_GT_BOXES", "10", "MODEL.ROI_HEADS.NUM_CLASSES", "20",
]
STREAM_BATCHES = 6


def rank_loaders(device, devkit, opts):
    """This rank's batches of every split loader, built from a devkit: each
    training stream's first STREAM_BATCHES batches and, fast-forwarded past
    2, its next 2; the test and TTA loaders' image ids."""
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import (
        DatasetCatalog, RegisterVOC, build_classifier_loader, build_classifier_strong_loader,
        build_strong_loader, build_test_loader, build_tta_test_loader)

    cfg = get_cfg()
    cfg.merge_from_list(list(opts) + ["DATASETS.CLASSIFIER_DATAROOT", devkit])
    DatasetCatalog.clear()
    RegisterVOC(cfg, devkit).register_all()
    out = {}
    for name, build in (("strong", build_strong_loader), ("classifier", build_classifier_loader),
                        ("classifier_strong", build_classifier_strong_loader)):
        loader = build(cfg, seed=3, image_loader=seeded_image_loader)
        it = iter(loader)
        batches = [next(it) for _ in range(STREAM_BATCHES)]
        resumed = build(cfg, seed=3, image_loader=seeded_image_loader)
        resumed.fast_forward(2)
        it = iter(resumed)
        out[name] = (loader.batch_size, loader.sync_portrait_frac, batches,
                     [next(it) for _ in range(2)])
    for name, build in (("test", build_test_loader), ("tta", build_tta_test_loader)):
        loader, n = build(cfg, "voc_base_training_query_val", image_loader=seeded_image_loader)
        try:
            out[name] = (n, [b["image_id"] for b in loader])
        finally:
            loader.close()
    return out


# ------------------------------------------------------------------ the run loop
TINY = [
    "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "200", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "INPUT.MIN_SIZE_TRAIN", "(80, 96)", "INPUT.MAX_SIZE_TRAIN", "160",
    "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
    "SOLVER.IMS_PER_BATCH", "4", "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "2",
    "SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2",
    "TPU.MAX_GT_BOXES", "10", "TPU.COMPUTE_DTYPE", "float32", "SEED", "5",
    # random weights: unclipped, two steps leave the RPN with no valid proposal
    "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
]
# landscape and portrait images alternate in pairs, so that each rank's
# half of every record list ([rank::2]) holds both orientations
DEVKIT_SIZES = ((100, 120), (100, 120), (120, 100), (120, 100))


def seeded_image_loader(rec):
    """Float BGR content made from the record's id (the same in every rank)."""
    rng = np.random.RandomState(zlib.crc32(rec["image_id"].encode()) % 2**31)
    return rng.rand(rec["height"], rec["width"], 3).astype(np.float32) * 255


def cli(devkit, out, *flags):
    from unit_tpu_torch.engine import runner

    return runner.default_argument_parser().parse_args(
        ["--config-file", FLAGSHIP, "--device", "cpu", "--data-root", devkit, *flags,
         *TINY, "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out)])


def _audit_writes(root):
    """Record every file this process opens for writing, renames, removes or
    creates under ``root`` (an audit hook: it cannot be removed, so only a
    rank process that ends with the run installs it)."""
    root = os.path.abspath(root)
    seen = []
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def under(path):
        try:
            return os.path.abspath(os.fsdecode(path)).startswith(root)
        except TypeError:  # a file descriptor
            return False

    def hook(event, args):
        if event == "open" and under(args[0]):
            mode, flags = args[1], args[2]
            if (mode and any(c in mode for c in "wax+")) or (not mode and flags & write_flags):
                seen.append(("open", os.fsdecode(args[0])))
        elif event in ("os.rename", "os.remove", "os.mkdir") and under(args[0]):
            seen.append((event, os.fsdecode(args[0])))

    sys.addaudithook(hook)
    return seen


def voc_state(evaluator):
    """A VOC evaluator's GT and detections, in a canonical order."""
    dets = {c: sorted(tuple(float(x) if i else x for i, x in enumerate(d)) for d in v)
            for c, v in evaluator._dets.items() if v}
    gt = {c: {img: (g["boxes"].tolist(), g["difficult"].tolist()) for img, g in v.items()}
          for c, v in evaluator._gt.items()}
    return dets, gt


def capture_merged(states):
    """Make ``merge_gathered`` record the merged evaluator's state in ``states``."""
    from unit_tpu_torch.evaluation import evaluator as ev_mod

    real = ev_mod.merge_gathered

    def merge(evaluator):
        merged = real(evaluator)
        states.append(voc_state(merged))
        return merged

    return ev_mod, "merge_gathered", merge


def rank_run(device, args):
    """One rank of a run whose group the caller made: what it wrote, its
    evaluations (and the merged evaluator of each) and its final parameters'
    digest."""
    from unit_tpu_torch.checkpoint import checkpointer
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner

    written = _audit_writes(args.opts[args.opts.index("OUTPUT_DIR") + 1])
    evals, models, states = [], [], []
    module, name, merge = capture_merged(states)
    setattr(module, name, merge)
    real_hook = checkpointer.PeriodicCheckpointerWithEval.__call__

    def hook(self, step, metrics, trainer):
        real_hook(self, step, metrics, trainer)
        if self.last_eval_results is not None and step % self.eval_period == 0:
            evals.append((step, self.last_eval_results))
        models[:] = [trainer.model]

    checkpointer.PeriodicCheckpointerWithEval.__call__ = hook
    DatasetCatalog.clear()
    final = runner.run(args, image_loader=seeded_image_loader)
    checkpointer.PeriodicCheckpointerWithEval.__call__ = real_hook
    return {"written": list(written), "evals": evals, "final": final, "states": states,
            "digest": params_digest(models[0]), "stop": stop_at_depth()}


def strip_time(results):
    return {k: v for k, v in results.items() if k != "inference_seconds_per_image"}


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    from tests.test_torch_data import write_devkit

    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"), sizes=DEVKIT_SIZES)


@pytest.fixture(scope="module")
def world_two_run(devkit, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_run")
    ranks = spawn(tmp_path_factory.mktemp("rdzv"), rank_run, cli(devkit, out),
                  timeout=TIMEOUT)
    return out, ranks


def test_run_loop_at_world_two_writes_on_rank_zero_only(world_two_run):
    out, (a, b) = world_two_run
    assert b["written"] == []
    opened = {os.path.relpath(p, out) for kind, p in a["written"] if kind == "open"}
    assert {"log.txt", "metrics.json", "best_info.json"} <= opened
    assert {"step_2.pt", "step_4.pt"} <= set(os.listdir(out))
    assert a["digest"] == b["digest"]  # the ranks end with one state


def test_run_loop_at_world_two_evaluates_like_one_process(world_two_run, devkit,
                                                          monkeypatch):
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner

    out, (a, b) = world_two_run
    assert [s for s, _ in a["evals"]] == [2, 4]
    for (_, ra), (_, rb) in zip(a["evals"], b["evals"]):
        assert strip_time(ra) == strip_time(rb)  # every rank scores the whole set
    assert strip_time(a["final"]) == strip_time(b["final"]) == strip_time(a["evals"][-1][1])
    assert len(a["states"]) == 3 and a["states"] == b["states"]  # at 2, at 4, final
    states = []
    monkeypatch.setattr(*capture_merged(states))
    DatasetCatalog.clear()
    alone = runner.run(cli(devkit, out, "--eval-only", "--resume"),
                       image_loader=seeded_image_loader)
    (dets, gt), = states
    want_dets, want_gt = a["states"][-1]
    assert gt == want_gt and sum(map(len, gt.values())) > 0
    assert dets == want_dets and sum(map(len, dets.values())) == 8 * 100
    gathered = a["final"]["bbox"]
    assert set(alone["bbox"]) == set(gathered)
    for k in ("AP", "AP50", "AP75", "novel_mean"):
        assert np.isfinite(alone["bbox"][k]) and abs(gathered[k] - alone["bbox"][k]) <= 1e-6, k
    assert gathered["class_AP50"] == alone["bbox"]["class_AP50"]


def test_run_loop_at_world_two_resumes_bit_identically(world_two_run, devkit, tmp_path,
                                                       monkeypatch):
    from unit_tpu_torch.checkpoint import read_checkpoint
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner

    out, _ = world_two_run
    resumed = tmp_path / "resumed"
    shutil.copytree(out, resumed)
    os.remove(resumed / "step_4.pt")
    DatasetCatalog.clear()
    # the runner's own spawn: --num-gpus 2 with --device cpu (gloo), bounded
    monkeypatch.setattr(runner, "launch", functools.partial(launch, timeout=TIMEOUT))
    results = runner.run(cli(devkit, resumed, "--resume", "--num-gpus", "2"),
                         image_loader=seeded_image_loader)
    assert np.isfinite(results["bbox"]["AP50"])
    want, got = read_checkpoint(str(out / "step_4.pt")), read_checkpoint(
        str(resumed / "step_4.pt"))
    assert want["step"] == got["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(v, got["model"][k]), k
    for k, st in want["optimizer"]["state"].items():
        assert torch.equal(st["momentum_buffer"], got["optimizer"]["state"][k]["momentum_buffer"])


def test_a_stop_on_one_rank_at_depth_eight_stops_both_on_one_step(world_two_run):
    """Rank 1 asks to stop after step 3; its flag reaches rank 0 in the
    all-reduce of the first resolution, step 1's, made when step 9 is
    queued: both ranks stop after step 9, with the same global losses."""
    _, (a, b) = world_two_run
    assert a["stop"][:2] == b["stop"][:2] == (1 + STOP_DEPTH, True)
    assert STOP_AT < a["stop"][0] <= STOP_AT + STOP_DEPTH
    assert a["stop"][2] == b["stop"][2] and len(a["stop"][2]) == 1 + STOP_DEPTH
    assert all(np.isfinite(v) for v in a["stop"][2])


def test_num_gpus_above_the_cards_present_raises(devkit, tmp_path, monkeypatch):
    from unit_tpu_torch.engine import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = cli(devkit, tmp_path, "--num-gpus", "4")
    args.device = "cuda"
    with pytest.raises(ValueError, match="--num-gpus 4 asks for 4 cards; 1 present"):
        runner.run(args)
    assert not os.listdir(tmp_path)  # refused before anything ran
