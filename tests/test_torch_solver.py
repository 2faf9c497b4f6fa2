"""The solver: unit_tpu_torch's SGD vs unit_tpu's optax chain.

Identical gradients (seeded numpy, one array per flax leaf) go into
unit_tpu.solver.build_optimizer (optax) and unit_tpu_torch.solver's SGD for
three updates that cross the warm-up and a milestone (WARMUP_ITERS 2,
STEPS (2,)).  Parameters start from seeded N(0, 0.1) values and the LR is
large enough that an update is a visible fraction of them; after every
update each parameter leaf agrees to 1e-6 of its largest element: both apply
the same f32 update, rounded in another order (a few ulps of the update; with
clipping by norm, the f32 sums of the global norm over ~1e6 gradients differ
by ~1e-6, which scales the update, not the parameter).  Frozen leaves do not
move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unit_tpu.config import get_cfg
from unit_tpu.solver import build as jbuild
from unit_tpu_torch.checkpoint import flax_leaves, flax_path
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer, is_frozen, lr_factor_for, warmup_multistep

RTOL = 1e-6


def solver_cfg(**solver):
    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
        "SOLVER.WARMUP_ITERS", "2", "SOLVER.STEPS", "(2,)", "SOLVER.BASE_LR", "0.1",
        "SOLVER.WARMUP_FACTOR", "0.1",
        "SOLVER.REFINEMENT_LR_FACTOR", "0.5", "SOLVER.MIL_LR_FACTOR", "3.0",
        "SOLVER.DELTA_LR_FACTOR", "2.0", "SOLVER.BIAS_LR_FACTOR", "1.5",
    ])
    for k, v in solver.items():
        node, key = cfg, k.split(".")
        for part in key[:-1]:
            node = node[part]
        node[key[-1]] = v
    return cfg


def unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


CASES = {
    "freeze_and_bias_decay": {"MODEL.FREEZE_LAYERS.FAST_RCNN": ["oicr_predictors"],
                              "SOLVER.WEIGHT_DECAY_BIAS": 0.0},
    "nesterov": {"SOLVER.NESTEROV": True, "SOLVER.WEIGHT_DECAY_BIAS": 3e-4},
    "clip_value": {"SOLVER.CLIP_GRADIENTS.ENABLED": True,
                   "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "value",
                   "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 0.5},
    "clip_norm": {"SOLVER.CLIP_GRADIENTS.ENABLED": True,
                  "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "norm",
                  "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 5.0},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_optax(case):
    cfg = solver_cfg(**CASES[case])
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    params = {k: jnp.asarray(v) for k, v in flax_leaves(model).items()}
    tx = jbuild.build_optimizer(cfg, unflatten(params))
    opt_state = tx.init(unflatten(params))
    jparams = unflatten(params)
    solver = build_optimizer(cfg, model)
    torch_params = dict(model.named_parameters())
    rng = np.random.RandomState(1)
    frozen = {p for p in params if is_frozen(p, cfg)}
    assert any(p.startswith("backbone/res2") for p in frozen)
    if case == "freeze_and_bias_decay":
        assert "weak_detector/oicr_predictor_1/kernel" in frozen
    before = flax_leaves(model)
    for _ in range(3):
        grads = {p: rng.randn(*v.shape).astype(np.float32) for p, v in params.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, unflatten(grads)), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        solver.optimizer.zero_grad()
        for name, p in torch_params.items():
            if p.requires_grad:
                p.grad = torch_layout(grads[flax_path(name, p)])
        if solver.clip is not None:
            solver.clip()
        solver.optimizer.step()
        solver.scheduler.step()
        want = _flat(jparams)
        got = flax_leaves(model)
        for path in got:
            err = np.abs(got[path] - want[path]).max()
            assert err <= RTOL * np.abs(want[path]).max() + 1e-12, (case, path, err)
    after = flax_leaves(model)
    for path in params:
        moved = not np.array_equal(before[path], after[path])
        assert moved != (path in frozen), path


def torch_layout(g):
    """A flax-layout leaf in the torch layout: HWIO -> OIHW, [in, out] -> [out, in]."""
    if g.ndim == 4:
        g = g.transpose(3, 2, 0, 1)
    elif g.ndim == 2:
        g = g.T
    return torch.as_tensor(np.ascontiguousarray(g))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_warmup_multistep_matches():
    want = jbuild.warmup_multistep(0.02, (12, 20), 0.1, 0.001, 10)
    got = warmup_multistep(0.02, (12, 20), 0.1, 0.001, 10)
    for count in range(26):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=RTOL)
    flat = warmup_multistep(0.5, (3,), 0.5, 0.1, 0)
    assert flat(0) == 0.5 and flat(3) == 0.25


def test_groups_factors_and_freezing():
    """lr_factor_for and is_frozen agree with unit_tpu on every parameter
    path, an OICR bias takes the refinement factor, and the SGD has one group
    per (factor, weight decay) pair."""
    cfg = solver_cfg(**{"MODEL.FREEZE_LAYERS.ROI_HEADS": ["weak_box_head"],
                        "SOLVER.WEIGHT_DECAY_BIAS": 0.0})
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    paths = list(flax_leaves(model)) + ["embeddings", "backbone/res2/block0/conv1_bn/mean"]
    for p in paths:
        assert lr_factor_for(p, cfg) == jbuild.lr_factor_for(p, cfg), p
        assert is_frozen(p, cfg) == jbuild.is_frozen(p, cfg), p
    assert lr_factor_for("weak_detector/oicr_predictor_0/bias", cfg) == 0.5
    solver = build_optimizer(cfg, model)
    groups = {(g["lr"], g["weight_decay"]) for g in solver.optimizer.param_groups}
    assert len(groups) == len(solver.optimizer.param_groups)
    trainable = {id(p) for g in solver.optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert p.requires_grad == (id(p) in trainable), name
    assert not model.weak_box_head.res5.block0.conv1.weight.requires_grad
    assert not model.backbone.res2.block0.conv1.weight.requires_grad
    assert model.backbone.res3.block0.conv1.weight.requires_grad
