"""TPU.REMAT_BACKBONE: the backbone recomputed in backward, against the key off and unit_tpu.

unit_tpu wraps the backbone in ``jax.checkpoint`` under the key
(meta_arch.py:302-307, :420-427); the port runs it under
``torch.utils.checkpoint(use_reentrant=False)`` (``WSRCNN._run_backbone``), the
preprocess outside.  With tests/test_torch_losses.py's small flagship in the
keep-everything regime, f32:

  * ``ModelConfig.from_cfg`` reads the key;
  * the losses and every gradient with the key on are bit-identical to those
    with it off (the backbone draws nothing random; FrozenBN is constant);
  * one step with the key on against unit_tpu's step with
    ``remat_backbone=True``: tests/test_torch_train.py's bounds (losses rtol
    1e-4, each leaf's update 2e-3 * max|update_jax| + 1e-9);
  * the bytes the backbone saves for backward, counted by
    ``saved_tensors_hooks``, fall to its input's and nothing more;
  * PreciseBN's pass (no gradient: nothing recomputed) captures the same
    statistics, as many and bit-identical;
  * a pipeline stage's range (``engine.train._stage_segment``) runs under
    one checkpoint: with the key on, its FrozenBN layers run forward twice a
    step (once more in backward) as with the key off, not three times.

FSDP with the key on: tests/test_torch_fsdp.py
::test_fsdp_with_remat_is_bit_identical (its world-2 spawn); the 2-D mesh
with the key on: tests/test_torch_spatial.py.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_losses import jax_params, small_train_cfg, t, train_batches
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from tests.test_torch_train import LOSS_RTOL, UPDATE_ATOL, UPDATE_REL
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import make_train_step as jmake_train_step
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.engine import TrainerNoMeta
from unit_tpu_torch.engine.train import _stage_segment
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models.resnet import FrozenBN, num_units
from unit_tpu_torch.solver import build_optimizer
from unit_tpu_torch.utils import precise_bn


def remat_cfg(on=True):
    cfg = small_train_cfg()
    cfg.merge_from_list(["SOLVER.WARMUP_ITERS", "0", "TPU.REMAT_BACKBONE", str(on)])
    return cfg


def with_remat(model, on):
    model.mc = dataclasses.replace(model.mc, remat_backbone=on)
    return model


@pytest.fixture(scope="module")
def model_and_batches():
    cfg = remat_cfg(False)
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0))
    build_optimizer(cfg, model)  # freezes the stem and res2, as the trainer does
    strong, weak = train_batches(seed=2)
    return model, {k: t(v) for k, v in strong.items()}, {k: t(v) for k, v in weak.items()}


def test_from_cfg_reads_the_key():
    assert ModelConfig.from_cfg(remat_cfg(True)).remat_backbone is True
    assert ModelConfig.from_cfg(remat_cfg(False)).remat_backbone is False
    assert ModelConfig.from_cfg(small_train_cfg()).remat_backbone is False  # the default


def losses_and_grads(model, strong, weak, on):
    with_remat(model, on)
    model.zero_grad(set_to_none=True)
    losses = model.train_losses(torch.Generator().manual_seed(1), strong, weak)
    torch.stack(list(losses.values())).sum().backward()
    return ({k: v.detach().clone() for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})


def test_losses_and_gradients_are_bit_identical_to_the_key_off(model_and_batches):
    model, strong, weak = model_and_batches
    off = losses_and_grads(model, strong, weak, False)
    on = losses_and_grads(model, strong, weak, True)
    with_remat(model, False)
    assert on[0].keys() == off[0].keys() and on[1].keys() == off[1].keys()
    assert all(torch.equal(on[0][k], off[0][k]) for k in off[0])
    assert len(off[1]) >= 30 and any(n.startswith("backbone.res4") for n in off[1])
    assert all(torch.equal(on[1][n], off[1][n]) for n in off[1]), [
        n for n in off[1] if not torch.equal(on[1][n], off[1][n])]


@pytest.fixture(scope="module")
def first_step():
    """unit_tpu's step with remat_backbone=True and the port's with the key on."""
    cfg = remat_cfg(True)
    jm, params = jax_params(cfg)
    assert jm.mc.remat_backbone
    strong, weak = train_batches()
    jax_before = flatten_tree(jax.tree.map(np.asarray, params))
    tx = jbuild_optimizer(cfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    new_state, metrics = jmake_train_step(jm, tx)(
        state, jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak), None,
        jax.random.PRNGKey(0))
    jax_after = flatten_tree(jax.tree.map(np.asarray, new_state.params))
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    assert model.mc.remat_backbone
    load_jax_params(model, jax_before)
    before = flax_leaves(model)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.repeat(strong),
                            itertools.repeat(weak), seed=0)
    trainer.init_state()
    got = trainer.run_step()
    return {k: float(v) for k, v in metrics.items()}, jax_before, jax_after, before, \
        flax_leaves(model), got


def test_step_with_the_key_on_matches_unit_tpus(first_step):
    jax_metrics, jax_before, jax_after, before, after, got = first_step
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    for path in before:
        want = jax_after[path] - jax_before[path]
        bound = UPDATE_REL * np.abs(want).max() + UPDATE_ATOL
        assert np.abs(after[path] - before[path] - want).max() <= bound, path


def saved_bytes(model, images, on):
    """Bytes that autograd saves for backward in ``features(images)``
    outside any checkpoint (a checkpoint's inner saves go to its own hooks)."""
    with_remat(model, on)
    total = [0]

    def pack(x):
        total[0] += x.numel() * x.element_size()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        model.features(images)
    with_remat(model, False)
    return total[0]


def test_the_backbone_saves_less_for_backward(model_and_batches):
    model, strong, _ = model_and_batches
    images = strong["image"]
    off, on = saved_bytes(model, images, False), saved_bytes(model, images, True)
    print(f"saved for backward in the backbone: {off} bytes with the key off, {on} on")
    # off: res3's and res4's activations (the frozen stem and res2 save
    # nothing); on: the checkpoint's input alone, the preprocessed images
    assert on <= images.numel() * 4 < off / 4


def test_precise_bn_captures_the_same_statistics(model_and_batches):
    model, strong, _ = model_and_batches
    off = precise_bn.collect_bn_stats(with_remat(model, False), strong["image"])
    on = precise_bn.collect_bn_stats(with_remat(model, True), strong["image"])
    with_remat(model, False)
    n_backbone = sum(isinstance(m, FrozenBN) for m in model.backbone.modules())
    assert len(on) == len(off) == n_backbone
    assert all(torch.equal(a, b) for k in off for a, b in zip(on[k], off[k]))


def frozen_bn_forwards(model, run, strong, weak):
    """FrozenBN forward calls of one forward and backward of ``run``."""
    calls = [0]
    handles = [m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
               for m in model.backbone.modules() if isinstance(m, FrozenBN)]
    try:
        run(strong, weak, None).float().sum().backward()
    finally:
        for h in handles:
            h.remove()
    return calls[0]


@pytest.mark.parametrize("early_stop", [True, False], ids=["early_stop", "full_recompute"])
@pytest.mark.parametrize("units", [(0, None), (0, 3)], ids=["whole", "range"])
def test_a_pipeline_range_recomputes_once(model_and_batches, units, early_stop):
    """Nested, the model's checkpoint inside the stage's costs a third
    forward where the recompute runs to its end (``early_stop`` off; torch's
    default early stop happens to spare it at this size)."""
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        range_recomputes_once(*model_and_batches, units)


def range_recomputes_once(model, strong, weak, units):
    n = num_units(model.mc.depth)
    units = (units[0], units[1] or n)
    n_bn = sum(isinstance(m, FrozenBN) for m in model.backbone.modules())
    counts = {}
    for on in (False, True):
        with_remat(model, on)
        counts["plain", on] = frozen_bn_forwards(
            model, _stage_segment(model, units, n, remat=False), strong, weak)
        counts["stage", on] = frozen_bn_forwards(
            model, _stage_segment(model, units, n, remat=True), strong, weak)
    with_remat(model, False)
    model.zero_grad(set_to_none=True)
    forward = counts["plain", False]
    # depth 26: the whole backbone, or the stem, res2's block and res3's
    assert forward == (n_bn if units[1] == n else 1 + 4 + 4)
    assert counts["plain", True] == counts["stage", False] == counts["stage", True] == 2 * forward
