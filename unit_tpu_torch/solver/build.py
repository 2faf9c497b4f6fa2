"""Optimizer construction: SGD + warmup multistep LR + per-group LR factors +
freezing + gradient clipping.

Port of unit_tpu/solver/build.py:21-215.  unit_tpu builds one optax chain
(zero the frozen gradients -> clip -> weight decay -> momentum trace -> LR
schedule -> per-leaf factor); here the same update is a ``torch.optim.SGD``:

  * frozen parameters (BACKBONE.FREEZE_AT stages, MODEL.FREEZE_LAYERS, the
    embeddings) get ``requires_grad_(False)``, so autograd builds no graph
    for them (the stem and res2 of the recipe): the counterpart of the XLA
    dead-code elimination that unit_tpu's zeroed gradients arrange;
  * one parameter group per (LR factor, weight decay) pair: WEIGHT_DECAY on
    weights, WEIGHT_DECAY_BIAS on biases, factors by ``lr_factor_for``
    (refinement, then MIL, then delta, then bias);
  * the LR is a ``LambdaLR`` of ``warmup_multistep`` stepped after each
    update, so update k uses the schedule at k (optax's count);
  * clipping (SOLVER.CLIP_GRADIENTS) by value or by global norm over the
    trainable parameters, before the update.  The norm is that of the whole
    gradient under FSDP and TP too: an FSDP shard's squares are summed over
    its data ranks, a TP slice's over the model group, and a whole
    gradient, the same on every model rank, counts once.

Names are the flax paths of the parameters (checkpoint.jax_params.flax_path),
so the path rules are those of unit_tpu verbatim.  ``modify_for_weak_only``
is the optimizer of the reference's weak-only phase (everything but the weak
branch frozen); as in unit_tpu, no trainer builds it.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..checkpoint.jax_params import flax_path
from ..parallel import comm

# parameter-path fragments identifying the reference's LR groups
_REFINEMENT_KEYS = ("oicr_predictor", "regression_branch")
_MIL_KEYS = ("classifier_stream", "detection_stream")
_DELTA_KEYS = ("cls_score_delta", "bbox_pred_delta", "cls_score_ft", "bbox_pred_ft")


def warmup_multistep(
    base_lr: float,
    steps: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 1000,
    warmup_iters: int = 1000,
) -> Callable[[int], float]:
    """detectron2's WarmupMultiStepLR: linear warm-up, then a factor
    ``gamma`` at each milestone; a function of the number of updates done."""
    milestones = sorted(steps)

    def schedule(count: int) -> float:
        if warmup_iters <= 0:
            warm = 1.0
        else:
            alpha = min(max(count / warmup_iters, 0.0), 1.0)
            warm = warmup_factor * (1.0 - alpha) + alpha
        return base_lr * warm * gamma ** sum(count >= m for m in milestones)

    return schedule


def _freeze_backbone_prefixes(freeze_at: int) -> List[str]:
    """BACKBONE.FREEZE_AT: 1 freezes the stem, k >= 2 the stem and res2..res_k."""
    out = []
    if freeze_at >= 1:
        out.append("backbone/stem")
    for stage in range(2, min(freeze_at, 5) + 1):
        out.append(f"backbone/res{stage}")
    return out


def lr_factor_for(path: str, cfg) -> float:
    if any(k in path for k in _REFINEMENT_KEYS):
        return cfg.SOLVER.REFINEMENT_LR_FACTOR
    if any(k in path for k in _MIL_KEYS):
        return cfg.SOLVER.MIL_LR_FACTOR
    if any(k in path for k in _DELTA_KEYS):
        return cfg.SOLVER.DELTA_LR_FACTOR
    if path.endswith("/bias"):
        return cfg.SOLVER.BIAS_LR_FACTOR
    return 1.0


def is_frozen(path: str, cfg, extra_frozen: Iterable[str] = ()) -> bool:
    """Whether a parameter never updates: frozen BN statistics, the GloVe
    embeddings, frozen backbone stages, MODEL.FREEZE_LAYERS entries and the
    path fragments of ``extra_frozen`` (``modify_for_weak_only``)."""
    if "_bn/" in path or path.endswith("_bn") or "/bn/" in path:
        return True
    if "embeddings" in path:
        return True
    for prefix in _freeze_backbone_prefixes(cfg.MODEL.BACKBONE.FREEZE_AT):
        if path.startswith(prefix):
            return True
    freeze_cfg = cfg.MODEL.FREEZE_LAYERS
    named = list(freeze_cfg.FAST_RCNN) + list(freeze_cfg.ROI_HEADS) + list(
        freeze_cfg.META_ARCH
    ) + list(freeze_cfg.BOX_HEAD) + list(freeze_cfg.MASK_HEAD)
    # the reference's freeze lists name torch submodules; map the common ones
    alias = {
        "backbone": "backbone",
        "proposal_generator": "rpn_head",
        "rpn_head": "rpn_head",
        "box_head": "box_head/",
        "weak_box_head": "weak_box_head",
        "weak_detector_head": "weak_detector",
        "cls_score_delta": "cls_score_delta",
        "bbox_pred_delta": "bbox_pred_delta",
        "classifier_stream": "classifier_stream",
        "detection_stream": "detection_stream",
        "oicr_predictors": "oicr_predictor",
        "embeddings": "embeddings",
    }
    segments = path.split("/")

    def seg_match(frag: str) -> bool:
        # segment-wise, so freezing 'box_head' does not catch 'weak_box_head';
        # the prefix match covers numbered heads (oicr_predictor_0)
        frag = frag.strip("/")
        return any(s == frag or s.startswith(frag + "_") or s.startswith(frag)
                   and s[len(frag):len(frag) + 1].isdigit() for s in segments)

    for name in named:
        frag = alias.get(name, name)
        if frag and seg_match(frag):
            return True
    bounded = "/" + path + "/"
    for frag in extra_frozen:
        if not frag:
            continue
        if "/" in frag:
            # contained at segment boundaries: 'box_head/' must not catch
            # 'weak_box_head/...'
            if "/" + frag.strip("/") + "/" in bounded:
                return True
        elif seg_match(frag):
            return True
    return False


class Solver(NamedTuple):
    """What unit_tpu's optax chain holds, as PyTorch objects."""

    optimizer: torch.optim.SGD
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip: Optional[Callable[[], None]]  # clips the trainable gradients in place


def _clip_fn(cfg, params: List[nn.Parameter]) -> Optional[Callable[[], None]]:
    clip = cfg.SOLVER.CLIP_GRADIENTS
    if not clip.ENABLED:
        return None
    value = float(clip.CLIP_VALUE)
    if clip.CLIP_TYPE == "value":
        def by_value():
            for p in params:
                if p.grad is not None:
                    _local(p.grad).clamp_(-value, value)
        return by_value

    def by_norm():
        # optax.clip_by_global_norm: g * max / |g| when |g| >= max, on the
        # device (no host sync)
        live = [p for p in params if p.grad is not None]
        grads = [_local(p.grad) for p in live]
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        for group, index in _split_groups(live).items():  # a split gradient's norm: its ranks'
            squares = comm.all_reduce_sum(torch.stack([norms[i] for i in index]).square(), group)
            for i, norm in zip(index, squares.sqrt()):
                norms[i] = norm
        norm = torch.linalg.vector_norm(torch.stack(norms))
        scale = torch.where(norm < value, 1.0, value / norm)
        torch._foreach_mul_(grads, scale)
    return by_norm


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of an FSDP shard (a DTensor); ``t`` otherwise."""
    return t.to_local() if isinstance(t, DTensor) else t


def _split_groups(params) -> dict:
    """{process group over which a split parameter's parts lie: the indices
    of ``params`` split over it}: an FSDP shard's mesh group, the model
    group for TP; whole parameters are in none."""
    groups: dict = {}
    for i, p in enumerate(params):
        if comm.is_split(p):
            group = p.device_mesh.get_group() if isinstance(p, DTensor) else p.tp_group
            groups.setdefault(group, []).append(i)
    return groups


def build_optimizer(cfg, model: nn.Module, extra_frozen: Iterable[str] = ()) -> Solver:
    """SGD(momentum, nesterov, weight decay) with per-group LR factors, the
    freeze list (and ``extra_frozen``'s path fragments) applied as
    ``requires_grad_(False)``, the warm-up multistep schedule and the
    configured gradient clipping."""
    extra_frozen = tuple(extra_frozen)
    groups = {}
    trainable = []
    for name, param in model.named_parameters():
        path = flax_path(name, param)
        if is_frozen(path, cfg, extra_frozen):
            param.requires_grad_(False)
            continue
        param.requires_grad_(True)
        trainable.append(param)
        decay = cfg.SOLVER.WEIGHT_DECAY_BIAS if path.endswith("bias") else cfg.SOLVER.WEIGHT_DECAY
        key = (float(lr_factor_for(path, cfg)), float(decay))
        groups.setdefault(key, []).append(param)
    base_lr = cfg.SOLVER.BASE_LR
    # FSDP's shards (DTensors) beside whole tensors: one tensor at a time
    # (the multi-tensor kernels refuse the mix); the same arithmetic
    kinds = {isinstance(p, DTensor) for p in trainable}
    optimizer = torch.optim.SGD(
        [{"params": ps, "lr": base_lr * f, "weight_decay": wd}
         for (f, wd), ps in groups.items()],
        lr=base_lr, momentum=cfg.SOLVER.MOMENTUM, nesterov=cfg.SOLVER.NESTEROV,
        foreach=False if len(kinds) > 1 else None,
    )
    schedule = warmup_multistep(1.0, cfg.SOLVER.STEPS, cfg.SOLVER.GAMMA,
                                cfg.SOLVER.WARMUP_FACTOR, cfg.SOLVER.WARMUP_ITERS)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return Solver(optimizer, scheduler, _clip_fn(cfg, trainable))


def modify_for_weak_only(cfg, model: nn.Module) -> Solver:
    """modify_optimizer_C4: the reference's TRAIN_ONLY_WEAK phase freezes the
    supervised branch, the box head, the RPN and the backbone; the weak
    detector and its box head train."""
    return build_optimizer(cfg, model,
                           extra_frozen=["supervised", "box_head/", "rpn_head", "backbone"])
