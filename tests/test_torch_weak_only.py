"""The weak detector's alternatives: unit_tpu_torch vs unit_tpu on shared weights.

PCL training (WEAK_DETECTOR.TYPE PCL), TrainerOnlyWeak's ``train_only_weak``
routing, the RPN self-training of WeaklySupervisedRCNNRPN, WeakRCNN's
``predict_weak_only``, the weak-only optimizer, the trainer choice, and the
run loop with TrainerOnlyWeakFineTune and with WeakRCNN.

Models: the small flagship of tests/test_torch_losses.py (depth 26,
RES2_OUT_CHANNELS 64, 160x224 canvas, f32, the keep-everything sampling
regime, so the two packages' different RNGs draw nothing that matters);
random flax weights go through load_jax_params.

Bounds, those of tests/test_torch_losses.py and tests/test_torch_slice.py:
  * train_losses: every loss to rtol 1e-4, and every trainable leaf's
    gradient within 2e-3 * max|g_jax| + 1e-6 of jax.grad's (an R-26 in two
    libraries); a leaf outside the step's graph has no gradient here and an
    all-zero one in unit_tpu;
  * RPN self-training: the port reuses the weak images' features and RPN
    outputs of the training pass where unit_tpu runs the backbone on them
    twice more; the values are the same and the gradient is a sum in another
    order, held to the same bounds.  A pseudo box is a proposal, which is the
    RPN's own decoded box, so at the anchor it came from the target delta
    equals the predicted one up to rounding; the recipe's RPN smooth-L1 beta
    of 0 makes the gradient there the sign of that rounding difference, in
    either package (measured: 38 times the bound on rpn_head/anchor_deltas).
    The gradient comparison therefore runs at MODEL.RPN.SMOOTH_L1_BETA 0.1,
    where it is continuous (measured: 0.011 of the bound); the losses are
    held at the recipe's beta as well;
  * detections: the same classes, scores within 2e-3, boxes within 0.05 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu.data.loader as jloader
import unit_tpu_torch.data as tdata
from tests.test_torch_data import assert_same_batch, seeded_image_loader, write_devkit
from tests.test_torch_losses import jax_params, t, train_batches
from tests.test_torch_runner import FLAGSHIP, TINY
from tests.test_torch_slice import assert_same_detections, images_and_sizes
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.engine import runner as jrunner
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.solver.build import is_frozen as jis_frozen
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_path
from unit_tpu_torch.engine import runner
from unit_tpu_torch.engine.train import (
    Trainer,
    TrainerFineTune,
    TrainerNoMeta,
    TrainerOnlyWeak,
    TrainerOnlyWeakFineTune,
)
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer, is_frozen, modify_for_weak_only

TRAIN_RTOL = 1e-4
GRAD_REL, GRAD_ATOL = 2e-3, 1e-6
PCL = "configs/VOC/VOC-RCNN-101-C4-split1-pcl.yaml"


def variant_cfg(path=FLAGSHIP, *opts):
    """A recipe at the small flagship's size (tests/test_torch_losses.py's,
    with its RPN test top-k cut too)."""
    cfg = jget_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "600", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "600", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
        "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128",
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0", "TPU.COMPUTE_DTYPE", "float32", *opts])
    return cfg


def train_pair(cfg, train_only_weak=False):
    """(unit_tpu losses, port losses, unit_tpu gradients, port gradients) of
    one train_losses + backward on shared weights and batches."""
    jm, params = jax_params(cfg)
    strong, weak = train_batches()

    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          train_only_weak=train_only_weak, method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(cfg, tm)  # freezes the stem and res2, as the trainer does
    w = {k: t(v) for k, v in weak.items()}
    w["labels_host"] = w["labels"].clone()  # what the trainer adds
    losses_t = tm.train_losses(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in strong.items()}, w,
                               train_only_weak=train_only_weak)
    torch.stack(list(losses_t.values())).sum().backward()
    return ({k: float(v) for k, v in losses_j.items()},
            {k: float(v.detach()) for k, v in losses_t.items()},
            flatten_tree(jax.tree.map(np.asarray, grads_j)), flax_leaves(tm, grads=True))


def assert_losses_match(pair, keys):
    losses_j, losses_t, _, _ = pair
    assert set(losses_t) == set(losses_j) == set(keys)
    for k in losses_j:
        np.testing.assert_allclose(losses_t[k], losses_j[k], rtol=TRAIN_RTOL, err_msg=k)


def assert_gradients_match(pair, outside=()):
    """Every gradient against jax.grad's; the leaves without one here are
    the frozen stem and res2 and those under the ``outside`` prefixes (not
    in the step's graph), whose unit_tpu gradient is zero."""
    _, _, grads_j, grads_t = pair
    none = {k for k, v in grads_t.items() if v is None}
    frozen = {k for k in grads_t if k.startswith(("backbone/stem", "backbone/res2"))}
    assert none == frozen | {k for k in grads_t if k.startswith(tuple(outside))}, none ^ frozen
    for path, g in grads_t.items():
        want = grads_j[path]
        if g is None:
            if path not in frozen:
                assert not np.any(want), path
            continue
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)


OICR_KEYS = {"loss_im_cls", "loss_oicr_1", "loss_oicr_2", "loss_oicr_3"}
RPN_KEYS = {"loss_rpn_cls", "loss_rpn_loc"}


# ------------------------------------------------------------------ PCL
@pytest.fixture(scope="module")
def pcl_pair():
    return train_pair(variant_cfg(PCL))


def test_pcl_recipe_distils_its_fields():
    cfg = variant_cfg(PCL)
    from unit_tpu.models.meta_arch import ModelConfig as JModelConfig

    jmc, tmc = JModelConfig.from_cfg(cfg), ModelConfig.from_cfg(cfg)
    for f in ("weak_detector_type", "num_kmeans_cluster", "graph_iou_threshold", "max_pc_num",
              "rpn_self_training", "weak_rpn_score_threshold"):
        assert getattr(tmc, f) == getattr(jmc, f), f
    assert tmc.weak_detector_type == "PCL"


def test_pcl_train_losses_match(pcl_pair):
    assert_losses_match(pcl_pair, RPN_KEYS | {"loss_cls", "loss_box_reg"} | OICR_KEYS)
    assert pcl_pair[1]["loss_oicr_1"] > 0


def test_pcl_train_gradients_match(pcl_pair):
    assert_gradients_match(pcl_pair)


# ------------------------------------------------------------------ train_only_weak
@pytest.fixture(scope="module")
def only_weak_pair():
    return train_pair(variant_cfg(), train_only_weak=True)


def test_train_only_weak_losses_match(only_weak_pair):
    assert_losses_match(only_weak_pair, RPN_KEYS | OICR_KEYS)


def test_train_only_weak_gradients_match(only_weak_pair):
    # the strong stream's heads are skipped: the supervised branch and the
    # box head (the weak stream has its own) are outside the step
    assert_gradients_match(only_weak_pair, outside=("supervised/", "box_head/"))


# ------------------------------------------------------------------ RPN self-training
@pytest.fixture(scope="module")
def self_training_pair():
    # smooth-L1 beta 0.1: a continuous gradient where a pseudo box is the
    # RPN's own decoded box (see the module docstring)
    return train_pair(variant_cfg(FLAGSHIP, "MODEL.META_ARCHITECTURE", "WeaklySupervisedRCNNRPN",
                                  "MODEL.PROPOSAL_GENERATOR.WEAK_RPN_SCORE_TRESHOLD", "0.0",
                                  "MODEL.RPN.SMOOTH_L1_BETA", "0.1"))


def test_self_training_train_losses_match(self_training_pair):
    assert_losses_match(self_training_pair, RPN_KEYS | {"loss_cls", "loss_box_reg"} | OICR_KEYS
                        | {"loss_rpn_cls_weak", "loss_rpn_loc_weak"})
    assert self_training_pair[1]["loss_rpn_loc_weak"] > 0  # pseudo boxes at threshold 0


def test_self_training_gradients_match(self_training_pair):
    """The reused features and RPN outputs: the same gradient as unit_tpu's
    two extra backbone passes, summed in another order."""
    assert_gradients_match(self_training_pair)


@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_self_training_losses_at_thresholds(threshold):
    """``rpn_self_training_losses`` alone (its own backbone pass), at the
    thresholds of tests/test_rpn_self_training.py: 2.0 keeps no pseudo box
    (no localisation loss), 0.0 every detection of a labelled class; the
    recipe's smooth-L1 beta of 0."""
    cfg = variant_cfg(FLAGSHIP, "MODEL.META_ARCHITECTURE", "WeaklySupervisedRCNNRPN",
                      "MODEL.PROPOSAL_GENERATOR.WEAK_RPN_SCORE_TRESHOLD", str(threshold))
    jm, params = jax_params(cfg)
    _, weak = train_batches()
    want = jax.jit(lambda p, w: jm.apply({"params": p}, w, threshold,
                                         method=JWSRCNN.rpn_self_training_losses))(
        params, jax.tree.map(jnp.asarray, weak))
    tm = WSRCNN(ModelConfig.from_cfg(cfg)).eval()
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tm.rpn_self_training_losses({k: t(v) for k, v in weak.items()})
    assert set(got) == set(want) == {"loss_rpn_cls_weak", "loss_rpn_loc_weak"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TRAIN_RTOL, err_msg=k)
    assert (float(got["loss_rpn_loc_weak"]) == 0.0) == (threshold == 2.0)


# ------------------------------------------------------------------ predict_weak_only
def test_predict_weak_only_detections_match():
    cfg = variant_cfg(FLAGSHIP, "MODEL.META_ARCHITECTURE", "WeakRCNN")
    jm, params = jax_params(cfg)
    images, sizes = images_and_sizes()
    dj = jax.jit(lambda p, i, s: jm.apply({"params": p}, i, s, method=JWSRCNN.predict_weak_only))(
        params, jnp.asarray(images), jnp.asarray(sizes))
    tm = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    predict = runner.make_predict_fn(tm)  # routes a WeakRCNN model to predict_weak_only
    dt = predict(images, sizes)
    with torch.inference_mode():
        direct = tm.predict_weak_only(t(images), t(sizes))
    assert torch.equal(direct.boxes, dt.boxes) and torch.equal(direct.scores, dt.scores)
    for i in range(2):
        def recs(boxes, scores, classes, valid):
            return [{"box": list(boxes[k]), "score": float(scores[k]),
                     "class_id": int(classes[k])} for k in np.flatnonzero(valid)]
        want = recs(*(np.asarray(a)[i] for a in (dj.boxes, dj.scores, dj.classes, dj.valid)))
        got = recs(*(a[i].numpy() for a in (dt.boxes, dt.scores, dt.classes, dt.valid)))
        assert_same_detections(got, want)
    # a score is a sum of three softmax probabilities: above 1 is possible
    assert 0.0 < float(dt.scores.max()) <= 3.0


# ------------------------------------------------------------------ optimizer, trainers
def test_modify_for_weak_only_freezes_what_unit_tpu_freezes():
    cfg = variant_cfg()
    extra = ["supervised", "box_head/", "rpn_head", "backbone"]
    # the six modules of tests/test_prefetcher_weak_only.py
    for path, frozen in [("backbone/stem/kernel", True), ("rpn_head/conv/kernel", True),
                         ("box_head/res5/kernel", True),
                         ("supervised/cls_score_delta/kernel", True),
                         ("weak_box_head/res5/kernel", False),
                         ("weak_detector/classifier_stream/kernel", False)]:
        assert is_frozen(path, cfg, extra) == jis_frozen(path, cfg, extra) == frozen, path
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    solver = modify_for_weak_only(cfg, model)
    trainable = {flax_path(n, p) for n, p in model.named_parameters() if p.requires_grad}
    for name, param in model.named_parameters():
        path = flax_path(name, param)
        assert (path in trainable) == (not jis_frozen(path, cfg, extra)), path
    assert trainable and all(p.startswith(("weak_box_head/", "weak_detector/")) for p in trainable)
    assert sum(len(g["params"]) for g in solver.optimizer.param_groups) == len(trainable)
    # plain build_optimizer, as every trainer uses, trains the rest again
    build_optimizer(cfg, model)
    assert any(p.requires_grad for n, p in model.named_parameters() if n.startswith("supervised."))


@pytest.mark.parametrize("name,want", [
    ("TrainerNoMeta", TrainerNoMeta), ("TrainerFineTune", TrainerFineTune),
    ("TrainerOnlyWeak", TrainerOnlyWeak), ("TrainerOnlyWeakFineTune", TrainerOnlyWeakFineTune),
    pytest.param("Trainer", Trainer, id="Trainer-None"),  # the meta trainer, ported
])
def test_trainer_class_for_all_five_names(name, want):
    tcfg, jcfg = runner.get_cfg(), jget_cfg()
    tcfg.merge_from_file(FLAGSHIP)
    jcfg.merge_from_file(FLAGSHIP)
    tcfg.ENGINE.TRAINER = jcfg.ENGINE.TRAINER = name
    assert runner.trainer_name_for(tcfg) == jrunner.trainer_class_for(jcfg).__name__ == name
    assert runner.trainer_class_for(tcfg) is want
    tcfg.ENGINE.TRAINER = jcfg.ENGINE.TRAINER = ""
    tcfg.MODEL.META_ARCHITECTURE = jcfg.MODEL.META_ARCHITECTURE = "WeakRCNN"
    assert runner.trainer_class_for(tcfg) is TrainerOnlyWeak
    assert jrunner.trainer_class_for(jcfg).__name__ == "TrainerOnlyWeak"


# ------------------------------------------------------------------ the run loop
@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"))


def run_one_step(devkit, out, monkeypatch, cls, *opts):
    """runner.run for one step and the final evaluation -> (results, trainer)."""
    made = []

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(runner, cls.__name__, Recording)
    tdata.DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args(
        ["--config-file", FLAGSHIP, "--device", "cpu", "--data-root", devkit, *TINY,
         "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out),
         "SOLVER.MAX_ITER", "1", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", *opts])
    results = runner.run(args, image_loader=seeded_image_loader)
    (trainer,) = made
    assert len(trainer.metrics_history) == 1 and trainer.state.step == 1
    assert all(np.isfinite(v) for v in trainer.metrics_history[0].values())
    assert all(np.isfinite(results["bbox"][k]) for k in ("AP", "AP50", "AP75"))
    return results, trainer


def test_only_weak_fine_tune_runner_step(devkit, tmp_path, monkeypatch):
    """The classifier datasets, with their boxes, are the strong stream (the
    same batches as unit_tpu's build_classifier_strong_loader) and there is
    no weak stream; the step has the supervised losses and no weak ones."""
    seen = []
    real = runner.build_classifier_strong_loader

    def spy(cfg, **kw):
        seen.append((cfg, kw))
        return real(cfg, **kw)

    monkeypatch.setattr(runner, "build_classifier_strong_loader", spy)
    _, trainer = run_one_step(devkit, tmp_path, monkeypatch, TrainerOnlyWeakFineTune,
                              "ENGINE.TRAINER", "TrainerOnlyWeakFineTune", "DATASETS.TRAIN", "()")
    assert trainer.weak_iter is None and len(seen) == 1
    m = trainer.metrics_history[0]
    assert {"loss_rpn_cls", "loss_cls", "loss_box_reg"} <= set(m) and not OICR_KEYS & set(m)
    # the stream against unit_tpu's, batch for batch
    cfg, kw = seen[0]
    jcfg = jget_cfg()
    jcfg.merge_from_file(FLAGSHIP)
    jcfg.merge_from_list([*TINY, "DATASETS.CLASSIFIER_DATAROOT", devkit])
    jdata.DatasetCatalog.clear()
    jdata.RegisterVOC(jcfg, devkit).register_all()
    got = iter(real(cfg, seed=kw["seed"], image_loader=seeded_image_loader))
    want = iter(jloader.build_classifier_strong_loader(jcfg, seed=kw["seed"],
                                                       image_loader=seeded_image_loader))
    for _ in range(3):
        assert_same_batch(next(got), next(want))


def test_weak_rcnn_runner_step(devkit, tmp_path, monkeypatch):
    """WeakRCNN: TrainerOnlyWeak (the RPN and the weak branch train) and the
    evaluation through predict_weak_only."""
    calls = []
    real = WSRCNN.predict_weak_only

    def spy(self, *a):
        calls.append(1)
        return real(self, *a)

    monkeypatch.setattr(WSRCNN, "predict_weak_only", spy)
    _, trainer = run_one_step(devkit, tmp_path, monkeypatch, TrainerOnlyWeak,
                              "MODEL.META_ARCHITECTURE", "WeakRCNN")
    assert trainer.train_only_weak and trainer.weak_iter is not None
    assert set(trainer.metrics_history[0]) == RPN_KEYS | OICR_KEYS | {"total_loss", "data_time"}
    assert len(calls) == 8  # one evaluated image a call (the devkit's 8 test images)
