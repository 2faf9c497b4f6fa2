"""The trainer: unit_tpu_torch's TrainerNoMeta vs unit_tpu's train step, and
the loop's contract (anomaly check before the hooks, resume, stop, options
that are not ported).

One step of the small flagship in the keep-everything regime (see
tests/test_torch_losses.py) goes through unit_tpu's jitted make_train_step
(optax) and through TrainerNoMeta.run_step.  With WARMUP_ITERS 0 the first
update is BASE_LR * (gradient + weight decay), ~1e-4 of the parameters,
large enough that f32 rounding of the parameters (~1e-8) stays far below
the bound: per leaf, the update p1 - p0 agrees with unit_tpu's to
2e-3 * max|update_jax| + 1e-9 (the gradients' bound of test_torch_losses,
scaled by the LR), and the losses to rtol 1e-4.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_losses import jax_params, small_train_cfg, train_batches
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from tests.test_torch_parallel_run import params_digest, rank_tiny_trainer, spawn
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import make_train_step as jmake_train_step
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine import TrainerNoMeta, make_train_step
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

LOSS_RTOL = 1e-4
UPDATE_REL, UPDATE_ATOL = 2e-3, 1e-9


def trainer_cfg():
    cfg = small_train_cfg()
    cfg.merge_from_list(["SOLVER.WARMUP_ITERS", "0"])
    return cfg


@pytest.fixture(scope="module")
def first_step():
    cfg = trainer_cfg()
    jm, params = jax_params(cfg)
    strong, weak = train_batches()
    jax_before = flatten_tree(jax.tree.map(np.asarray, params))
    tx = jbuild_optimizer(cfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    new_state, metrics = jmake_train_step(jm, tx)(
        state, jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak), None,
        jax.random.PRNGKey(0))
    jax_after = flatten_tree(jax.tree.map(np.asarray, new_state.params))

    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, jax_before)
    before = flax_leaves(model)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.repeat(strong),
                            itertools.repeat(weak), seed=0)
    trainer.init_state()
    seen = []
    trainer.train(1, hooks=[lambda step, m, tr: seen.append((step, dict(m)))])
    after = flax_leaves(model)
    trainer.train(3)  # two more steps on the same batches
    return (jax_before, jax_after,
            {k: float(v) for k, v in metrics.items()}, before, after, seen, trainer)


def test_first_step_matches_unit_tpu(first_step):
    jax_before, jax_after, jax_metrics, before, after, seen, _ = first_step
    assert [s for s, _ in seen] == [1]
    metrics = seen[0][1]
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    frozen = [p for p in before if p.startswith(("backbone/stem", "backbone/res2"))]
    assert frozen and all(np.array_equal(before[p], after[p]) for p in frozen)
    for path in before:
        np.testing.assert_array_equal(before[path], jax_before[path])
        want = jax_after[path] - jax_before[path]
        got = after[path] - before[path]
        bound = UPDATE_REL * np.abs(want).max() + UPDATE_ATOL
        assert np.abs(got - want).max() <= bound, (path, np.abs(got - want).max(), bound)
        if path not in frozen:
            assert np.abs(want).max() > 0, path


def test_three_steps(first_step):
    *_, trainer = first_step
    assert trainer.state.step == 3 and len(trainer.metrics_history) == 3
    for m in trainer.metrics_history:
        assert all(np.isfinite(v) for v in m.values())
        assert m["total_loss"] == pytest.approx(
            sum(v for k, v in m.items() if k.startswith("loss_")), rel=1e-5)
    assert trainer.optimizer.scheduler.last_epoch == 3


# ------------------------------------------------------------ loop contract
def tiny_trainer(strong=None, weak=None, **kw):
    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                         "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200",
                         "MODEL.RPN.POST_NMS_TOPK_TRAIN", "16",
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
                         "TPU.COMPUTE_DTYPE", "float32"])
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0))
    s, w = train_batches(seed=5, b=1)
    s = dict(s, image=s["image"][:, :64, :96], image_size=np.asarray([[64, 96]], np.float32),
             gt_boxes=s["gt_boxes"] * 0.4)
    w = dict(w, image=w["image"][:, :64, :96], image_size=np.asarray([[64, 96]], np.float32))
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.repeat(strong or s),
                            itertools.repeat(weak or w), seed=1, **kw)
    trainer.init_state()
    return trainer, s, w


def test_non_finite_loss_raises_before_any_hook():
    _, s, w = tiny_trainer()
    bad = dict(s, image=np.full_like(s["image"], np.nan))
    trainer, _, _ = tiny_trainer(strong=bad)
    calls = []
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 1") as err:
        trainer.train(3, hooks=[lambda *a: calls.append(a)])
    assert calls == [] and "loss_rpn_cls" in str(err.value)


def test_train_resumes_from_the_state_step_and_stops_on_request():
    trainer, _, _ = tiny_trainer()
    trainer.state.step = 2  # as restored from a checkpoint
    steps = []
    trainer.train(4, hooks=[lambda step, m, tr: steps.append(step)])
    assert steps == [3, 4] and trainer.state.step == 4

    def stop_at_5(step, metrics, tr):
        if step == 5:
            tr.request_stop()

    trainer.train(9, hooks=[stop_at_5])
    assert trainer.state.step == 5 and len(trainer.metrics_history) == 3


def test_same_seed_same_step():
    """The step's generator is seeded from (seed, step): two trainers built
    alike take the same first step."""
    (a, _, _), (b, _, _) = tiny_trainer(), tiny_trainer()
    ma, mb = a.run_step(), b.run_step()
    ma.pop("data_time"), mb.pop("data_time")
    assert ma == mb


def test_make_train_step_returns_detached_losses():
    trainer, s, w = tiny_trainer()
    solver = trainer.optimizer
    step = make_train_step(trainer.model, solver.optimizer, solver.scheduler, solver.clip)
    out = step({k: torch.as_tensor(v) for k, v in s.items()},
               {k: torch.as_tensor(v) for k, v in w.items()}, torch.Generator().manual_seed(0))
    assert "total_loss" in out and not any(v.requires_grad for v in out.values())


@pytest.mark.parametrize("same_canvas", [True, False])
def test_train_losses_selects_proposals_once_for_a_fused_batch(monkeypatch, same_canvas):
    """Streams on one canvas: one proposal selection (one NMS launch on the
    card) over strong + weak images; other canvases: one a stream.  Either
    way the proposals, and with them every loss, are those of a selection per
    stream: exactly equal (images do not see each other)."""
    from unit_tpu_torch.models import rpn as rpn_lib

    trainer, s, w = tiny_trainer()
    if not same_canvas:
        w = dict(w, image=w["image"][:, :48, :80], image_size=np.asarray([[48, 80]], np.float32))
    s, w = ({k: torch.as_tensor(v) for k, v in d.items()} for d in (s, w))
    real, calls = rpn_lib.select_proposals, []

    def counting(logits, *a, **kw):
        calls.append(logits.shape[0])
        return real(logits, *a, **kw)

    def per_image(logits, deltas, anchors, sizes, *a, **kw):
        parts = [real(logits[i:i + 1], deltas[i:i + 1], anchors, sizes[i:i + 1], *a, **kw)
                 for i in range(logits.shape[0])]
        return type(parts[0])(**{f: torch.cat([getattr(x, f) for x in parts])
                                 for f in ("boxes", "objectness", "valid")})

    monkeypatch.setattr(rpn_lib, "select_proposals", counting)
    got = trainer.model.train_losses(torch.Generator().manual_seed(3), s, w)
    assert calls == ([2] if same_canvas else [1, 1])
    monkeypatch.setattr(rpn_lib, "select_proposals", per_image)
    want = trainer.model.train_losses(torch.Generator().manual_seed(3), s, w)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k].detach()) == float(want[k].detach()), k


@pytest.mark.parametrize("kwargs,item", [
    # the support stream is ported (tests/test_torch_meta.py); the case keeps
    # its name and holds pipeline parallelism with a support stream instead:
    # unit_tpu refuses it first for its single micro-batch (train.py:617)
    pytest.param({"meta_iter": iter(()), "pp": True}, "GRAD_ACCUM", id="kwargs0-item 23"),
    # FSDP and TP are ported (tests/test_torch_fsdp.py, test_torch_tp.py):
    # without a mesh the trainer ignores them, as unit_tpu's does, and takes
    # the plain step, bit for bit (item "plain")
    pytest.param({"tp": True}, "plain", id="kwargs1-items 27 and 29"),
    # data parallelism is ported (tests/test_torch_parallel*.py): a trainer in
    # a process group of two ranks trains; the case keeps its name
    pytest.param({}, "trains", id="kwargs2-items 27 and 29"),
    pytest.param({"fsdp": True}, "plain", id="kwargs3-items 27 and 29"),
    # pipeline parallelism is ported (tests/test_torch_pipeline*.py): at
    # unit_tpu's least GRAD_ACCUM and without a mesh it refuses, as unit_tpu's
    # pipeline step asserts its stage axis (train.py:274)
    pytest.param({"pp": True, "grad_accum": 2}, "'stage' mesh axis",
                 id="kwargs4-items 27 and 29"),
])
def test_unported_trainer_options_raise(kwargs, item, tmp_path):
    if item == "trains":
        a, b = spawn(tmp_path, rank_tiny_trainer)
        assert a["world"] == b["world"] == 2
        assert a["digest"] == b["digest"] and a["losses"] == b["losses"]
        assert all(np.isfinite(v) for v in a["losses"])
        return
    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16"])
    if item == "plain":
        got, want = (tiny_steps(cfg, **kw) for kw in (kwargs, {}))
        assert got == want and all(np.isfinite(v) for m in got[1] for v in m)
        return
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    error = NotImplementedError if item.startswith("item") else ValueError
    with pytest.raises(error, match=item):
        TrainerNoMeta(model, build_optimizer(cfg, model), **kwargs)


def tiny_steps(cfg, **kwargs):
    """Two steps of a seeded tiny flagship on one seeded batch pair: (the
    parameters' digest, the losses of each step)."""
    rng = np.random.RandomState(0)
    strong = dict(image=rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32),
                  image_size=np.asarray([[64, 96]], np.float32),
                  gt_boxes=np.asarray([[[10, 8, 50, 40], [30, 20, 90, 60]]], np.float32),
                  gt_classes=np.asarray([[0, 3]], np.int32), gt_valid=np.ones((1, 2), bool))
    labels = np.zeros((1, 20), np.float32)
    labels[0, [0, 3]] = 1.0
    weak = dict(image=rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[64, 96]], np.float32))
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(1))
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.repeat(strong),
                            itertools.repeat(weak), seed=1, **kwargs)
    trainer.init_state()
    trainer.train(2)
    return params_digest(model), [[v for k, v in m.items() if k != "data_time"]
                                  for m in trainer.metrics_history]


def test_model_config_training_fields():
    """The port distils the training fields of the recipe as unit_tpu does."""
    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    jmc, tmc = JModelConfig.from_cfg(cfg), ModelConfig.from_cfg(cfg)
    for f in ("roi_batch_size", "roi_positive_fraction", "roi_iou_thresholds",
              "roi_iou_labels", "proposal_append_gt", "weak_proposal_count", "detector_temp",
              "classifier_temp", "weak_detector_type", "rpn_self_training"):
        assert getattr(tmc, f) == getattr(jmc, f), f
    assert tmc.detector_temp == 2.0 and tmc.weak_proposal_count == 512
    for f in tmc.weak._fields:
        assert getattr(tmc.weak, f) == getattr(jmc.weak, f), f
    for f in tmc.rpn._fields:
        assert getattr(tmc.rpn, f) == getattr(jmc.rpn, f), f
    assert (tmc.rpn.pre_nms_topk_train, tmc.rpn.post_nms_topk_train) == (12000, 2000)
    assert tmc.frcnn.smooth_l1_beta == jmc.frcnn.smooth_l1_beta
