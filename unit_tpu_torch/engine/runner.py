"""CLI runner utilities: argument parsing, config setup, end-to-end train/eval.

Port of unit_tpu/engine/runner.py: build cfg from YAML and dotted
overrides, register datasets, construct the trainer for the configured
meta-architecture, run training with checkpoint and evaluation hooks (with
resume and a save on preemption), or run eval-only.

What differs from unit_tpu, on purpose:
  * ``--device`` (default ``cuda``): the model is built on the card; without
    one the run raises instead of carrying on on the CPU.  Tests pass
    ``--device cpu``;
  * ``build_everything`` and ``run`` take an optional ``image_loader``
    (record -> float BGR array), threaded to every loader as ``make_eval_fn``
    already takes one, so a run needs no image files;
  * the training streams hand out batches in pinned memory when the model is
    on a card (``data.loader.pin_batch``);
  * ``MODEL.WEIGHTS`` naming ``<run>/best/model`` (unit_tpu's orbax
    directory, as the fine-tune recipes spell it) reads the port's
    ``<run>/best/model.pt``;
  * ``--num-gpus N`` above the cards present raises (unit_tpu scales the
    config for N and then clamps its mesh to the devices it finds: ROADMAP
    fault R15).
Trainers: ``TrainerNoMeta`` (base training), ``Trainer`` (the meta recipe:
a third, support stream for the visual attention head; its evaluations
first compute the support prototypes, which inference does not read, and
run through ``inference_on_dataset_meta``), ``TrainerFineTune`` (k-shot
fine-tuning, warm-started from a base run's snapshot), ``TrainerOnlyWeak``
(the weak branch and the RPN; ``WeakRCNN`` configs) and
``TrainerOnlyWeakFineTune`` (the classifier datasets with their boxes as the
strong stream).

Data parallelism, one process a rank (``parallel``): ``--num-gpus N``
spawns N ranks on cards 0..N-1 over NCCL (with ``--device cpu``, N CPU
ranks over gloo); ``--dist`` joins the group torchrun describes in the
environment; a caller that has initialised a group (``parallel.launch``)
calls ``run`` in every rank.  ``auto_scale_workers`` scales the config to
the world; IMS_PER_BATCH is the global batch.  Each rank trains and
evaluates on its shard of the records, every rank reads checkpoints, rank 0
alone writes files (checkpoints, the best snapshot, metrics, log.txt,
traces), and every rank returns the same results.

Evaluations run the multi-scale + flip test-time augmentation under
TEST.AUG.ENABLED; TEST.PRECISE_BN refreshes the FrozenBN statistics before
each periodic evaluation (``PreciseBNHook``), and TPU.PROFILE_START_STEP
traces a window of steps on rank 0 (``utils.profiling``).  Under
MODEL.LOAD_PROPOSALS the loaders carry the DATASETS.PROPOSAL_FILES_* proposals
and every evaluation (TTA included) scores them in place of the RPN's.

FSDP and TP (TPU.FSDP, TPU.TP; ``parallel.mesh``): ``build_everything``
builds unit_tpu's mesh over the ranks (runner.py:207-225): ("data", "model")
of world / TP x TP under TPU.TP > 1 (the ranks must divide), ("data",) under
TPU.FSDP at world > 1; one process runs the plain step, as unit_tpu ignores
FSDP without a mesh.  It splits the model over the mesh, then builds the
solver and the trainer.  Checkpoints are one process's format whatever the
topology (``checkpoint.checkpointer``), and each evaluation predicts on a
whole replica of the model, loaded once an evaluation from the gathered
state (``on_whole_replica``) and dropped after it: predict holds no
collective, so ranks with unequal image counts cannot hang, and every rank
evaluates its shard of the test set as data-parallel ranks do; PreciseBN
runs on such a replica too and copies the statistics back.

Pipeline parallelism (TPU.PP, TPU.PP_STAGES = S): the ("data", "stage")
mesh of world / S x S (S must divide the ranks; not with TPU.TP or
TPU.FSDP), every rank holding the whole model, and the pipeline trainer
(``engine.train.make_pipeline_train_step``).  Its evaluations are the data
parallel ones, each rank on its shard of the test set with the replica it
holds, and rank 0 writes its checkpoints, as under data parallelism.  A
resume fast-forwards each stream by start_step * TPU.GRAD_ACCUM batches, as
unit_tpu's does, and so drops the batches that the joint pairing had left
waiting for a group (ROADMAP R18, kept for parity).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import (
    Checkpointer,
    PeriodicCheckpointerWithEval,
    load_glove_embeddings,
    load_torch_resnet,
    merge_params_from_checkpoint,
    resolve_own_checkpoint,
)
from ..config import get_cfg, validate_registry_names
from ..data import (
    DatasetCatalog,
    Prefetcher,
    build_classifier_loader,
    build_classifier_strong_loader,
    build_strong_loader,
    build_support_loader,
    build_test_loader,
    build_tta_test_loader,
)
from ..data.loader import _host_shard, pin_batch
from ..data.utils import get_evaluator, register_datasets
from ..evaluation import (
    inference_loop,
    inference_on_dataset,
    inference_on_dataset_meta,
)
from ..models import WSRCNN, ModelConfig
from ..parallel import comm, init_from_env, launch
from ..parallel import mesh as mesh_lib
from ..solver import build_optimizer
from ..solver.build import warmup_multistep
from ..utils.events import MetricsHook, print_csv_format
from ..utils.precise_bn import precise_bn
from ..utils.profiling import ProfileHook
from .predict import make_predict_fn, make_tta_predict_fn
from .train import (
    Trainer,
    TrainerFineTune,
    TrainerNoMeta,
    TrainerOnlyWeak,
    TrainerOnlyWeakFineTune,
)

logger = logging.getLogger("unit_tpu_torch")


def setup_logger(output_dir: Optional[str] = None, level: int = logging.INFO):
    """Configure the "unit_tpu_torch" logger for CLI runs: stream to stdout
    and a log.txt in OUTPUT_DIR.  The logger does not propagate, so a root
    handler installed by another library neither drops nor doubles its lines.
    A later run in the same process with another OUTPUT_DIR moves the file
    log to its own directory."""
    lg = logging.getLogger("unit_tpu_torch")
    lg.setLevel(level)
    lg.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s unit_tpu_torch]: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if not any(
        isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
        for h in lg.handlers
    ):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        lg.addHandler(sh)
    if output_dir:
        path = os.path.abspath(os.path.join(output_dir, "log.txt"))
        for h in [h for h in lg.handlers if isinstance(h, logging.FileHandler)]:
            if h.baseFilename != path:
                lg.removeHandler(h)
                h.close()
        if not any(isinstance(h, logging.FileHandler) for h in lg.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            lg.addHandler(fh)
    return lg


def default_argument_parser():
    parser = argparse.ArgumentParser(description="unit_tpu_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="ranks, one process each on cards 0..N-1 (NCCL); with "
                             "--device cpu, N CPU ranks (gloo); under TPU.PP, N / "
                             "TPU.PP_STAGES data ranks of PP_STAGES stage ranks")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--dist", action="store_true",
                        help="join the process group torchrun describes in the environment")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (default) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def auto_scale_workers(cfg, num_workers: int):
    """SOLVER.REFERENCE_WORLD_SIZE linear-scaling-rule adjustment.

    When REFERENCE_WORLD_SIZE is nonzero and differs from the actual device
    count, the global batch and BASE_LR scale UP by num_workers/old, and the
    iteration-denominated quantities (MAX_ITER, WARMUP_ITERS, STEPS,
    EVAL_PERIOD, CHECKPOINT_PERIOD) scale DOWN, keeping total epochs and the
    LR-vs-epoch curve invariant.  REFERENCE_WORLD_SIZE is rewritten to
    num_workers so the scaling is idempotent (the saved config can be reused).
    """
    old = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old == 0 or old == num_workers:
        return cfg
    was_frozen = cfg.is_frozen()
    cfg = cfg.clone()
    cfg.defrost()
    if cfg.SOLVER.IMS_PER_BATCH % old != 0:
        raise ValueError(
            f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} not divisible by "
            f"REFERENCE_WORLD_SIZE {old}")
    scale = num_workers / old
    cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale)) for s in cfg.SOLVER.STEPS)
    cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.CHECKPOINT_PERIOD = int(round(cfg.SOLVER.CHECKPOINT_PERIOD / scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    logger.info(
        "auto_scale_workers: %d -> %d workers; IMS_PER_BATCH=%d BASE_LR=%g "
        "MAX_ITER=%d WARMUP_ITERS=%d STEPS=%s",
        old, num_workers, cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.BASE_LR,
        cfg.SOLVER.MAX_ITER, cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.STEPS)
    if was_frozen:
        cfg.freeze()
    return cfg


def resolve_device(name: Optional[str]) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU.  A missing card raises; nothing carries on on the CPU."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: unit_tpu_torch runs on the card; pass --device cpu "
            "to run on the CPU on purpose")
    return device


def setup(args):
    """The frozen config of a run, scaled to this process group's world
    (``auto_scale_workers``); rank 0 makes OUTPUT_DIR and logs to its log.txt,
    the other ranks log warnings to the console only."""
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg = auto_scale_workers(cfg, comm.world())
    cfg.freeze()
    validate_registry_names(cfg)  # reject unknown registry names at setup
    if comm.is_main():
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        setup_logger(cfg.OUTPUT_DIR)
    else:
        setup_logger(None, level=logging.WARNING)
    comm.barrier()  # OUTPUT_DIR exists for every rank
    if cfg.TPU.DEBUG_NANS:
        torch.autograd.set_detect_anomaly(True)
    register_datasets(cfg, args.data_root)
    return cfg


_TRAINERS = ("Trainer", "TrainerNoMeta", "TrainerFineTune", "TrainerOnlyWeak",
             "TrainerOnlyWeakFineTune")


def trainer_name_for(cfg) -> str:
    """The trainer unit_tpu picks for ``cfg`` (runner.py:182), by name."""
    explicit = getattr(cfg, "ENGINE", None) and cfg.ENGINE.TRAINER
    if explicit:
        if explicit not in _TRAINERS:
            raise KeyError(f"unknown ENGINE.TRAINER {explicit!r}; one of {sorted(_TRAINERS)}")
        return explicit
    if cfg.MODEL.META_ARCHITECTURE == "WeakRCNN":
        return "TrainerOnlyWeak"
    if "FineTune" in cfg.MODEL.ROI_HEADS.FAST_RCNN.NAME:
        return "TrainerFineTune"
    if cfg.MODEL.ROI_HEADS.NAME == "WSROIHead":
        return "Trainer"  # meta/support-stream trainer
    return "TrainerNoMeta"


def trainer_class_for(cfg):
    name = trainer_name_for(cfg)
    # looked up when called: chip_smoke.py and the tests substitute recording
    # trainers for these names
    return {"Trainer": Trainer, "TrainerNoMeta": TrainerNoMeta,
            "TrainerFineTune": TrainerFineTune,
            "TrainerOnlyWeak": TrainerOnlyWeak,
            "TrainerOnlyWeakFineTune": TrainerOnlyWeakFineTune}[name]


def build_everything(cfg, device: Optional[torch.device] = None, seed: int = 0,
                     start_step: int = 0, image_loader: Optional[Callable] = None):
    """(model, solver, trainer) for a config, the model on ``device``.

    ``start_step`` > 0 (--resume): every training stream is fast-forwarded
    past the batches the preempted run already consumed (``TPU.GRAD_ACCUM``
    a step; one support batch a step), so the resumed run sees exactly the
    data an uninterrupted run would have.  The weak (image-labelled) stream
    is built for base, meta and weak-only training: fine-tuning reads the
    k-shot strong stream alone, and TrainerOnlyWeakFineTune the classifier
    datasets as its strong stream.  ``Trainer`` also reads the support
    stream, seeded ``seed + 2``."""
    device = device if device is not None else resolve_device(None)
    mesh, fsdp, tp, pp = build_mesh(cfg, device)
    trainer_cls = trainer_class_for(cfg)
    model = WSRCNN(ModelConfig.from_cfg(cfg),
                   generator=torch.Generator().manual_seed(seed)).to(device)
    if (fsdp or tp) and not pp:
        (mesh_lib.fsdp_shard if fsdp else mesh_lib.tp_shard)(model, mesh)
        logger.info("%s over the %s mesh %s: %d of %d parameters split", "FSDP" if fsdp else "TP",
                    mesh.mesh_dim_names, tuple(mesh.shape),
                    sum(comm.is_split(p) for p in model.parameters()),
                    len(list(model.parameters())))
    grad_accum = int(getattr(cfg.TPU, "GRAD_ACCUM", 1) or 1)
    pin = pin_batch if device.type == "cuda" else None

    def stream(loader, per_step=grad_accum):
        # exact resume: each train step consumes per_step batches from this
        # stream; the Prefetcher's thread makes them (the support stream's
        # C * K resized shots too) while the device works, in the same order
        if start_step > 0:
            loader.fast_forward(start_step * per_step)
        return Prefetcher(iter(loader), transform=pin)

    name = trainer_name_for(cfg)
    if name == "TrainerOnlyWeakFineTune":
        strong_iter = stream(build_classifier_strong_loader(cfg, seed=seed,
                                                            image_loader=image_loader))
    elif not cfg.DATASETS.TRAIN:
        raise ValueError("DATASETS.TRAIN is empty")
    else:
        strong_iter = stream(build_strong_loader(cfg, seed=seed, image_loader=image_loader))
    weak_iter = meta_iter = None
    try:  # a stream that fails to build (R21's support lookup) stops the others
        if name in ("TrainerNoMeta", "TrainerOnlyWeak", "Trainer"):
            weak_iter = stream(build_classifier_loader(cfg, seed=seed + 1,
                                                       image_loader=image_loader))
        if name == "Trainer":
            meta_iter = stream(build_support_loader(cfg, support_dataset_name(cfg),
                                                    seed=seed + 2, image_loader=image_loader),
                               per_step=1)
        solver = build_optimizer(cfg, model)
        trainer = trainer_cls(model, solver, strong_iter=strong_iter, weak_iter=weak_iter,
                              meta_iter=meta_iter, seed=seed, grad_accum=grad_accum,
                              mesh=mesh, fsdp=fsdp, tp=tp, pp=pp)
    except BaseException:
        for it in (strong_iter, weak_iter, meta_iter):
            if it is not None:
                it.close()
        raise
    return model, solver, trainer


def build_mesh(cfg, device: torch.device):
    """(mesh, fsdp, tp, pp) of a config over this process group, as
    unit_tpu's runner builds them (runner.py:207-225): TPU.PP -> the
    (world / S, S) mesh of S = TPU.PP_STAGES (S must divide the ranks; not
    with TPU.TP); TPU.TP = M > 1 -> the (world / M, M) mesh (M must divide
    the ranks); TPU.FSDP at world > 1 -> the 1-D mesh; otherwise (None,
    False, False, False): data parallelism or one process.  Under PP
    ``fsdp`` is TPU.FSDP as given: the trainer refuses the pair."""
    tp = int(getattr(cfg.TPU, "TP", 1) or 1)
    if getattr(cfg.TPU, "PP", False):
        if tp != 1:
            raise ValueError("TPU.PP does not compose with TPU.TP")
        stages, n = int(cfg.TPU.PP_STAGES or 2), comm.world()
        if n % stages:
            raise ValueError(f"TPU.PP needs a device count divisible by "
                             f"TPU.PP_STAGES={stages}, got {n}")
        return (mesh_lib.make_mesh_pp(n // stages, stages, device.type), bool(cfg.TPU.FSDP),
                False, True)
    if tp > 1:
        n_data = comm.data_world(tp)  # ValueError unless TP divides the ranks
        if cfg.TPU.FSDP:
            raise ValueError("TPU.FSDP and TPU.TP are mutually exclusive sharding modes")
        return mesh_lib.make_mesh_tp(n_data, tp, device.type), False, True, False
    if cfg.TPU.FSDP and comm.world() > 1:
        return mesh_lib.make_mesh(comm.world(), device.type), True, False, False
    return None, False, False, False


def support_dataset_name(cfg) -> str:
    """The registered support dataset (records by class) of the few-shot suite.
    unit_tpu's mapping, kept for parity (ROADMAP R21): FEWSHOT.TYPE COCO_NOTE
    and COCO_DOCK fall through to ``voc_base_training_support``, so a note or
    dock run with the meta ROI heads fails on that lookup in both packages;
    their own support sets (``coco_note_base_training_support``,
    ``coco_dock_base_training_support``) are registered all the same."""
    return {"VOC": "voc_base_training_support",
            "COCO": "coco_base_training_support"}.get(cfg.DATASETS.FEWSHOT.TYPE,
                                                      "voc_base_training_support")


def meta_attention(cfg, model, image_loader: Optional[Callable] = None,
                   dataset_name: Optional[str] = None):
    """The prototypes a meta model's evaluation binds (unit_tpu runner.py:
    338-357): one deterministic batch of BASE_META_SHOTS shots a class of
    ``dataset_name`` (None: ``support_dataset_name``, as the evaluation reads
    it) through ``compute_meta_attention``, without autograd; None, with a
    warning, where the support dataset is not registered."""
    name = dataset_name or support_dataset_name(cfg)
    if name not in DatasetCatalog:
        logger.warning("meta eval: support dataset %s not registered; skipping the "
                       "attention precompute", name)
        return None
    batch = next(iter(build_support_loader(cfg, name, deterministic=True,
                                           image_loader=image_loader)))
    support = {k: torch.from_numpy(v).to(model.embeddings.device) for k, v in batch.items()}
    with torch.no_grad():
        return model.compute_meta_attention(support)


def load_initial_weights(cfg, model):
    """MODEL.WEIGHTS (one of this package's checkpoints, .npz, .pkl or .pth)
    and the GloVe embeddings into ``model``, in place."""
    weights = cfg.MODEL.WEIGHTS
    if weights:
        # <run>/best/model, as the fine-tune recipes name unit_tpu's snapshot,
        # is the port's <run>/best/model.pt
        weights = resolve_own_checkpoint(weights)
    if weights and not os.path.exists(weights):
        # silently evaluating a random-init model is far worse than failing
        raise FileNotFoundError(f"MODEL.WEIGHTS points at {weights!r}, which does not exist")
    if weights and (os.path.isdir(weights) or weights.endswith(".pt")):
        # a snapshot of one of our own runs (e.g. <base_run>/best/model.pt):
        # the fine-tune warm start, tolerant of missing and new tensors
        _, loaded, skipped = merge_params_from_checkpoint(model, weights)
        logger.info("warm-started %d tensors from %s (%d skipped)",
                    loaded, weights, len(skipped))
    elif weights:
        if weights.endswith(".npz"):
            sd = dict(np.load(weights))
        else:
            obj = torch.load(weights, map_location="cpu", weights_only=False)
            sd = obj.get("model", obj.get("state_dict", obj))
            sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
        _, loaded, skipped = load_torch_resnet(
            model, sd, load_res5_into=("box_head", "weak_box_head"))
        logger.info("loaded %d tensors from %s (%d skipped)", loaded, weights, len(skipped))
    emb = cfg.MODEL.ROI_HEADS.EMBEDDING_PATH
    if emb and os.path.exists(emb):
        load_glove_embeddings(model, emb)
        logger.info("loaded GloVe embeddings from %s", emb)
    return model


def on_whole_replica(model, fn: Callable):
    """``fn(net)`` with ``net`` a whole copy of ``model`` where FSDP or TP
    split it (``parallel.mesh``), for the passes that run without
    collectives (predict, PreciseBN); ``model`` itself where it is whole.
    The copy is loaded from the gathered state (a collective: every rank
    calls this), lives for the call and is dropped after it, so the training
    steps between evaluations never carry a second model."""
    if not mesh_lib.is_sharded(model):
        return fn(model)
    device = model.embeddings.device
    state = mesh_lib.full_state_dict(model)
    with torch.device("meta"):  # no initialisation: the state overwrites everything
        replica = WSRCNN(model.mc)
    replica = replica.to_empty(device=device)
    replica.load_state_dict(state)
    del state
    impls = {n: m.impl for n, m in model.named_modules() if hasattr(m, "impl")}
    for n, m in replica.named_modules():
        if n in impls:
            m.impl = impls[n]
    try:
        return fn(replica.train(model.training))
    finally:
        del replica
        if device.type == "cuda":
            torch.cuda.empty_cache()


def make_eval_fn(cfg, model, image_loader: Optional[Callable] = None):
    """state (or model) -> results of every dataset of DATASETS.TEST.

    Under TEST.AUG.ENABLED each image goes through the multi-scale + flip
    test-time augmentation (``build_tta_test_loader``, ``predict_tta``), at
    batch 1; a meta model then binds no prototypes, as in unit_tpu (its
    ``_meta_attention`` runs on the other branch only).  A model split by
    FSDP or TP predicts through a whole replica (``on_whole_replica``)."""
    use_tta = cfg.TEST.AUG.ENABLED

    def eval_fn(state):
        net = state.model if hasattr(state, "model") else state
        was_training = net.training
        try:
            return on_whole_replica(net, evaluate)
        finally:
            net.train(was_training)

    def evaluate(eval_net):
        # Accumulate per dataset; with a single test dataset return its
        # metrics flat, matching d2's DefaultTrainer.test.
        if getattr(cfg.TPU, "FOLD_BN_AT_EVAL", False):
            from ..utils.bn_fold import fold_frozen_bn

            eval_net = fold_frozen_bn(eval_net)  # a copy: training goes on unfolded
        if use_tta:
            predict = make_tta_predict_fn(eval_net, tta_topk=cfg.TPU.TTA_PROPOSAL_TOPK)
        else:
            predict = make_predict_fn(eval_net)
        # a meta model's prototypes, once an evaluation; inference does not read them
        attention = (meta_attention(cfg, eval_net, image_loader)
                     if eval_net.mc.use_meta and not use_tta else None)
        all_results = {}
        for name in cfg.DATASETS.TEST:
            evaluator = get_evaluator(cfg, name)
            # this rank's shard, as its test loader reads: the evaluators
            # are merged over the ranks before scoring, so the whole GT on
            # every rank would be counted world times
            for rec in _host_shard(DatasetCatalog.get(name)):
                evaluator.process_gt_record(rec)
            if use_tta:
                loader, n = build_tta_test_loader(cfg, name, image_loader=image_loader)
            else:
                loader, n = build_test_loader(
                    cfg, name, image_loader=image_loader,
                    batch_size=int(getattr(cfg.TPU, "EVAL_BATCH_SIZE", 1)),
                )
            try:
                if use_tta:
                    all_results[name] = inference_loop(predict, loader, evaluator, n)
                elif attention is None:
                    all_results[name] = inference_on_dataset(predict, loader, evaluator, n)
                else:
                    all_results[name] = inference_on_dataset_meta(
                        lambda _attention, *a: predict(*a), loader, attention,
                        evaluator, n)
            finally:
                loader.close()
        if len(all_results) == 1:
            return next(iter(all_results.values()))
        return all_results

    return eval_fn


class PreciseBNHook:
    """PreciseBN before each periodic evaluation (unit_tpu runner.py:486-510;
    d2's ``hooks.PreciseBN`` runs right before the checkpointer, so the
    refreshed statistics are both evaluated and saved).  ``loader_factory()``
    gives a fresh training stream each period; it is closed after
    ``num_iter`` batches.  It takes a step's losses in flight and drains
    them before it refreshes the statistics."""

    takes_lazy_metrics = True

    def __init__(self, loader_factory: Callable, eval_period: int, num_iter: int):
        self.loader_factory = loader_factory
        self.eval_period = eval_period
        self.num_iter = num_iter

    def __call__(self, step: int, metrics: dict, trainer):
        if not self.eval_period or step % self.eval_period != 0:
            return
        trainer.drain()
        # a split model's statistics: on its whole replica
        on_whole_replica(trainer.state.model, lambda net: self._refresh(net, trainer.state.model))
        logger.info("PreciseBN: refreshed FrozenBN statistics over %d batches", self.num_iter)

    def _refresh(self, net, model):
        loader = self.loader_factory()
        try:
            precise_bn(net, iter(loader), self.num_iter)
        finally:
            loader.close()
        if net is not model:  # FrozenBN buffers are whole on every rank
            buffers = dict(model.named_buffers())
            with torch.no_grad():
                for name, value in net.named_buffers():
                    buffers[name].copy_(value)


def run(args, image_loader: Optional[Callable] = None):
    """Train (or with ``--eval-only`` evaluate) as ``args`` say; returns the
    final evaluation's results (rank 0's, equal to every rank's), or None
    when preempted.  ``--dist`` joins torchrun's group; ``--num-gpus`` N > 1
    spawns N ranks (``image_loader`` then goes to them by its import path);
    in a group the caller made, this process is one rank."""
    num = int(getattr(args, "num_gpus", 1) or 1)
    device_type = resolve_device(getattr(args, "device", None)).type
    if getattr(args, "dist", False):
        device = init_from_env(device_type)
        try:
            return _run(device, args, image_loader)
        finally:
            dist.destroy_process_group()
    if comm.world() > 1:
        if num not in (1, comm.world()):
            raise ValueError(f"--num-gpus {num} inside a process group of {comm.world()} ranks")
        device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
                  else torch.device("cpu"))
        return _run(device, args, image_loader)
    if num > 1:
        if device_type == "cuda":
            present = torch.cuda.device_count()
            if num > present:
                raise ValueError(f"--num-gpus {num} asks for {num} cards; {present} present")
            devices, backend = list(range(num)), "nccl"
        else:  # --device cpu, on purpose
            devices, backend = ["cpu"] * num, "gloo"
        return launch(_run, num, devices, backend, args=(args, image_loader))[0]
    return _run(torch.device(args.device or "cuda"), args, image_loader)


def _run(device: torch.device, args, image_loader: Optional[Callable] = None):
    """One rank's run on ``device`` (one process: the only rank)."""
    cfg = setup(args)
    seed = cfg.SEED if cfg.SEED >= 0 else 0
    ckpt = Checkpointer(cfg.OUTPUT_DIR, max_to_keep=3)
    resume_step = ckpt.latest_step() if args.resume else None
    model, solver, trainer = build_everything(
        cfg, device, seed=seed,
        start_step=0 if args.eval_only else int(resume_step or 0),
        image_loader=image_loader,
    )
    profile_hook = None
    try:
        trainer.init_state()
        load_initial_weights(cfg, model)
        if resume_step is not None:
            ckpt.restore(state=trainer.state)
            logger.info("resuming from step %d", int(resume_step))
        comm.broadcast_module(model)  # every rank starts from rank 0's state

        eval_fn = make_eval_fn(cfg, model, image_loader=image_loader)
        if args.eval_only:
            results = eval_fn(trainer.state)
            logger.info("eval results: %s", results)
            print_csv_format(results)
            return results

        lr_schedule = warmup_multistep(
            cfg.SOLVER.BASE_LR, cfg.SOLVER.STEPS, cfg.SOLVER.GAMMA,
            cfg.SOLVER.WARMUP_FACTOR, cfg.SOLVER.WARMUP_ITERS,
        )
        metrics_hook = MetricsHook(cfg.OUTPUT_DIR, period=20, max_iter=cfg.SOLVER.MAX_ITER,
                                   lr_fn=lr_schedule)
        hooks = [metrics_hook]
        if cfg.TPU.PROFILE_START_STEP > 0 and comm.is_main():
            profile_hook = ProfileHook(os.path.join(cfg.OUTPUT_DIR, "trace"),
                                       start=cfg.TPU.PROFILE_START_STEP,
                                       num_steps=cfg.TPU.PROFILE_NUM_STEPS)
            hooks.append(profile_hook)
        if cfg.TEST.PRECISE_BN.ENABLED:
            pin = pin_batch if device.type == "cuda" else None
            hooks.append(PreciseBNHook(
                lambda: Prefetcher(iter(build_strong_loader(cfg, image_loader=image_loader)),
                                   transform=pin),
                eval_period=cfg.TEST.EVAL_PERIOD, num_iter=cfg.TEST.PRECISE_BN.NUM_ITER))
        hooks.append(PeriodicCheckpointerWithEval(
            ckpt, eval_fn, cfg.TEST.EVAL_PERIOD, cfg.SOLVER.CHECKPOINT_PERIOD,
            cfg.TEST.MIN_EVAL_PERIOD,
        ))
        # Preemption safety: SIGTERM or SIGINT asks for a clean loop exit
        # after the step in flight, then the state is saved below so --resume
        # continues from the preempted step.
        prev_handlers = {}

        def _on_preempt(signum, frame):
            logger.warning("signal %d: stopping after the current step", signum)
            trainer.request_stop()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_preempt)
            except ValueError:  # not the main thread (e.g. tests): skip
                pass
        try:
            # train() drains the losses in flight before it returns: the
            # preemption save below follows known, finite steps
            trainer.train(cfg.SOLVER.MAX_ITER, hooks=hooks)
            if trainer.stop_requested:
                step = int(trainer.state.step)
                if ckpt.latest_step() != step:  # the periodic hook may have just saved
                    logger.warning("preempted at iter %d: saving checkpoint", step)
                    ckpt.save(step, trainer.state, wait=True)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            if profile_hook is not None:
                profile_hook.close()  # training may have ended inside the window
            metrics_hook.close()
            ckpt.wait()
        if trainer.stop_requested:  # preempted: exit promptly, skip the final eval
            return None
        results = eval_fn(trainer.state)
        print_csv_format(results)
        return results
    finally:
        trainer.close()
