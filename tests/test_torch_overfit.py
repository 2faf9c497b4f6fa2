"""Learning dynamics of the port: the loss falls when a tiny WSRCNN overfits
one batch (the port of tests/test_overfit.py), and the port learns as
unit_tpu does from shared weights.

Both cases take tests/test_model_smoke.py's tiny model (depth 26, 7x7
pooling, OICR_ITER 2, 64x64 images), its one strong and one weak batch, and
25 steps of SGD with momentum 0.9 on every parameter; FrozenBN's weight,
bias, mean and var are buffers in the port and stay frozen, as unit_tpu's
solver freezes them ("/bn" paths).

The learning rate is 5e-4, not unit_tpu's test's 2e-3.  That test passes a
plain ``optax.sgd`` over the whole flax tree, so it also trains FrozenBN's
four tensors, which no solver of either package does.  With them frozen,
unit_tpu's own 25 steps at 2e-3 end in NaN from 4 of the initialisations
PRNGKey(0)..(5), its test's PRNGKey(0) among them, and fail the
``loss_im_cls`` criterion from the other 2; the port's, from seeds 0..5,
end in NaN.  At 5e-4 unit_tpu meets the criteria from PRNGKey 0, 4 and 5,
and the port from seeds 0, 2, 4 and 5 (the others keep ``loss_im_cls`` at
ln 2: the MIL head stuck at 0.5).

  * the port alone (seed 0): every loss finite, the last ``total_loss``
    below 0.7x the first's, ``loss_rpn_cls`` and ``loss_im_cls`` lower
    (unit_tpu's criteria);
  * the port against unit_tpu's jitted step from unit_tpu's initial weights
    (``checkpoint.load_jax_train_state``), FrozenBN frozen on both sides, in
    the keep-everything regime of tests/test_torch_losses.py (16 proposals
    an image and every ROI candidate sampled, positive fraction 1: the two
    packages cannot share an RNG): the first step's losses to rtol 1e-4
    (the bound of the existing parity tests), ``total_loss`` to rtol 1e-4
    through the first four steps (measured 2.0e-5 at most), and the learning
    criteria in both packages at the 25th.  From the fifth step on the
    trajectories part: the fifth differs by 1.1e-4 on two torch threads
    (1.2e-5 on four: the order of the sums moves it), a discrete choice (a
    proposal kept, a pseudo label mined) then flips on an f32 rounding, and
    by steps 11-25 the gap is 3-73% (measured), so the last step is held to
    the criteria and not to a bound.
"""

import dataclasses

import jax
import numpy as np
import optax
import torch

from tests.test_model_smoke import _strong_batch, _weak_batch
from tests.test_model_smoke import tiny_config as jtiny_config
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.engine import create_train_state as jcreate_train_state
from unit_tpu.engine import make_train_step as jmake_train_step
from unit_tpu.models import WSRCNN as JWSRCNN
from unit_tpu_torch.checkpoint import load_jax_train_state
from unit_tpu_torch.engine.train import TrainState
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import fast_rcnn as frcnn_lib
from unit_tpu_torch.models import rpn as rpn_lib
from unit_tpu_torch.models import similarity as sim_lib
from unit_tpu_torch.models import weak_losses as weak_lib
from unit_tpu_torch.solver import Solver

STEPS = 25
LR, MOMENTUM = 5e-4, 0.9
FIRST_RTOL = 1e-4
CONTINUOUS_STEPS = 4  # steps whose trajectories agree before a discrete choice parts them


def tiny_config(**kw):
    """tests/test_model_smoke.py::tiny_config in the port's ModelConfig."""
    base_ids = tuple(i for i in range(20) if i not in (2, 5, 9, 13, 17))
    novel_ids = (2, 5, 9, 13, 17)
    defaults = dict(
        depth=26, num_classes=20, base_ids=base_ids, novel_ids=novel_ids,
        multi_box_head=True, pooler_resolution=7, roi_batch_size=32,
        weak_proposal_count=32, oicr_iter=2,
        rpn=rpn_lib.RPNConfig(pre_nms_topk_train=200, pre_nms_topk_test=200,
                              post_nms_topk_train=64, post_nms_topk_test=64),
        frcnn=frcnn_lib.FastRCNNConfig(num_classes=20, topk_per_image=20),
        weak=weak_lib.WeakLossConfig(num_classes=20, oicr_iter=2),
        sim=sim_lib.SimilarityConfig(
            terms=(("cls", ("lingual", "visual")), ("bbox", ("lingual", "visual"))),
            base_ids=base_ids, novel_ids=novel_ids,
            coco_indexer=tuple(int(i) for i in sim_lib.coco_indexer_for(sim_lib.VOC_CLASSES))),
    )
    defaults.update(kw)
    return ModelConfig(**defaults)


def batches():
    strong = {k: torch.tensor(np.asarray(v)) for k, v in _strong_batch().items()}
    weak = {k: torch.tensor(np.asarray(v)) for k, v in _weak_batch().items()}
    return strong, weak


def sgd_solver(model):
    optimizer = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    return Solver(optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda k: 1.0), None)


def overfit(model, solver, steps=STEPS):
    """``steps`` SGD steps on the one batch pair: each step's losses and
    their sum (unit_tpu's ``total_loss``)."""
    strong, weak = batches()
    history = []
    for _ in range(steps):
        solver.optimizer.zero_grad(set_to_none=True)
        losses = model.train_losses(torch.Generator().manual_seed(42), strong, weak)
        total = torch.stack(list(losses.values())).sum()
        total.backward()
        solver.optimizer.step()
        history.append(dict({k: float(v.detach()) for k, v in losses.items()},
                            total_loss=float(total.detach())))
    return history


def test_single_batch_overfit_reduces_losses():
    model = WSRCNN(tiny_config(), generator=torch.Generator().manual_seed(0))
    history = overfit(model, sgd_solver(model))
    first, last = history[0], history[-1]
    assert all(np.isfinite(v) for m in history for v in m.values()), history
    assert last["total_loss"] < first["total_loss"] * 0.7, (first, last)
    assert last["loss_rpn_cls"] < first["loss_rpn_cls"]
    assert last["loss_im_cls"] < first["loss_im_cls"]


def frozen_bn_sgd():
    """optax SGD that leaves FrozenBN's tensors (and the embeddings, a buffer
    in the port) where they are, as unit_tpu's solver does."""
    def labels(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: "frozen" if any(
                getattr(k, "key", "").endswith("_bn") or getattr(k, "key", "") == "embeddings"
                for k in path) else "train", params)

    return optax.multi_transform({"train": optax.sgd(LR, momentum=MOMENTUM),
                                  "frozen": optax.set_to_zero()}, labels)


def learned(history):
    first, last = history[0], history[-1]
    return (all(np.isfinite(v) for m in history for v in m.values())
            and last["total_loss"] < first["total_loss"] * 0.7
            and last["loss_rpn_cls"] < first["loss_rpn_cls"]
            and last["loss_im_cls"] < first["loss_im_cls"])


def test_overfit_learns_as_unit_tpu_does():
    keep_all = dict(roi_batch_size=32, roi_positive_fraction=1.0)
    jmc = jtiny_config()
    jmodel = JWSRCNN(mc=dataclasses.replace(
        jmc, rpn=jmc.rpn._replace(post_nms_topk_train=16), **keep_all))
    opt = frozen_bn_sgd()
    state = jcreate_train_state(jmodel, opt, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    step = jmake_train_step(jmodel, opt)
    strong, weak = _strong_batch(), _weak_batch()
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, strong, weak, None, jax.random.PRNGKey(42))
        want.append({k: float(v) for k, v in metrics.items()})

    mc = tiny_config()
    model = WSRCNN(dataclasses.replace(mc, rpn=mc.rpn._replace(post_nms_topk_train=16),
                                       **keep_all))
    train_state = load_jax_train_state(TrainState(model, sgd_solver(model), 0), params)
    got = overfit(model, train_state.solver)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=FIRST_RTOL, err_msg=k)
    for k in range(CONTINUOUS_STEPS):
        np.testing.assert_allclose(got[k]["total_loss"], want[k]["total_loss"],
                                   rtol=FIRST_RTOL, err_msg=f"step {k + 1}")
    assert learned(want), want[-1]
    assert learned(got), got[-1]
