"""The meta (support-stream) recipe: unit_tpu_torch vs unit_tpu on shared weights.

configs/VOC/VOC-RCNN-101-C4-split1-meta.yaml (``WeaklySupervisedRCNN`` +
``WSROIHead`` under ``Trainer``) at the small flagship's size of
tests/test_torch_weak_only.py (depth 26, RES2_OUT_CHANNELS 64, 160x224
canvas, f32, the keep-everything sampling regime): ``compute_meta_attention``
and ``train_losses(meta=...)`` with their gradients, the support stream's
detachment from the backbone, the rank losses' slot count, the support
loader, the trainer choice, the run loop with an evaluation and a resume,
the meta evaluation loop, ``WSROIHeadFineTuneMeta`` and the solver's
groups.  Random flax weights go through load_jax_params; inputs are made
from a numpy seed.

Bounds, those of tests/test_torch_weak_only.py: every loss to rtol 1e-4 and
every trainable leaf's gradient within 2e-3 * max|g_jax| + 1e-6 of
jax.grad's; the support batches bit-identical.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data.loader as jloader
import unit_tpu_torch.data as tdata
import unit_tpu_torch.data.loader as tloader
from tests.test_torch_data import assert_same_batch, seeded_image_loader, write_devkit
from tests.test_torch_losses import BASE, jax_params, t, train_batches
from tests.test_torch_runner import TINY
from tests.test_torch_weak_only import (
    OICR_KEYS,
    RPN_KEYS,
    assert_gradients_match,
    assert_losses_match,
    variant_cfg,
)
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.engine import runner as jrunner
from unit_tpu.evaluation import PascalVOCEvaluator as JPascalVOCEvaluator
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.solver.build import is_frozen as jis_frozen
from unit_tpu.solver.build import lr_factor_for as jlr_factor_for
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_path
from unit_tpu_torch.engine import runner
from unit_tpu_torch.engine.train import Trainer
from unit_tpu_torch.evaluation import (
    PascalVOCEvaluator,
    inference_on_dataset,
    inference_on_dataset_meta,
)
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

META = "configs/VOC/VOC-RCNN-101-C4-split1-meta.yaml"
RANK_KEYS = {"loss_rank_margin", "loss_rank_reg", "loss_rank_cls"}
SHOTS, CANVAS = 2, 64


def support_batch(seed=4):
    """A support batch of 15 base classes x SHOTS shots on a CANVAS-pixel
    meta canvas, one class without support, one shot on the whole canvas."""
    rng = np.random.RandomState(seed)
    c = len(BASE)
    image = rng.uniform(0, 255, (c, SHOTS, CANVAS, CANVAS, 3)).astype(np.float32)
    xy = rng.uniform(0, CANVAS * 0.5, (c, SHOTS, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(12, CANVAS * 0.5, (c, SHOTS, 2))], -1)
    boxes = boxes.astype(np.float32)
    boxes[2, 0] = [0, 0, CANVAS, CANVAS]
    valid = np.ones(c, bool)
    valid[6] = False
    image[6] = 0.0
    return {"image": image, "boxes": boxes, "class_valid": valid}


def port_model(cfg, params):
    tm = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(cfg, tm)  # freezes the stem and res2, as the trainer does
    return tm


@pytest.fixture(scope="module")
def meta_pair():
    """(unit_tpu losses, port losses, unit_tpu gradients, port gradients,
    rank-loss rows) of one train_losses(meta=...) + backward."""
    cfg = variant_cfg(META)
    jm, params = jax_params(cfg)
    strong, weak = train_batches()
    meta = support_batch()

    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          meta=jax.tree.map(jnp.asarray, meta), method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = port_model(cfg, params)
    rows = []
    real = tm.visual_attention.rank_loss

    def spy(pooled, *a):
        rows.append(pooled.shape[0])
        return real(pooled, *a)

    tm.visual_attention.rank_loss = spy
    losses_t = tm.train_losses(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in strong.items()},
                               {k: t(v) for k, v in weak.items()},
                               meta={k: t(v) for k, v in meta.items()})
    torch.stack(list(losses_t.values())).sum().backward()
    return ({k: float(v) for k, v in losses_j.items()},
            {k: float(v.detach()) for k, v in losses_t.items()},
            flatten_tree(jax.tree.map(np.asarray, grads_j)), flax_leaves(tm, grads=True), rows)


def test_meta_recipe_distils_its_fields():
    cfg = variant_cfg(META)
    for name, mode in (("MeanSimilarity", "mean"), ("MahalanobisSimilarity", "mahalanobis"),
                       ("MeanMatrixSimilarity", "matrix"),
                       ("MeanMatrixSimilarityLocatron", "locatron")):
        cfg.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME = name
        jmc, tmc = JModelConfig.from_cfg(cfg), ModelConfig.from_cfg(cfg)
        for f in ("use_meta", "attention_mode", "rank_loss_slots", "meta_architecture"):
            assert getattr(tmc, f) == getattr(jmc, f), f
        assert tmc.use_meta and tmc.attention_mode == mode and tmc.rank_loss_slots == 100


def test_meta_train_losses_match(meta_pair):
    assert_losses_match(meta_pair[:4], RPN_KEYS | {"loss_cls", "loss_box_reg"} | OICR_KEYS
                        | RANK_KEYS)
    # the Gaussian likelihood underflows here too (D = 512): the constants
    assert meta_pair[1]["loss_rank_margin"] == np.float32(15 * 0.5 / 16)
    assert meta_pair[1]["loss_rank_reg"] == 1.0
    # the sampler emitted 64 proposals + 4 GT slots an image, fewer than the
    # 100 rank-loss slots: all of them, for both images
    assert meta_pair[4] == [2 * 68]


def test_meta_train_gradients_match(meta_pair):
    assert_gradients_match(meta_pair[:4])
    grads = meta_pair[3]
    assert np.abs(grads["visual_attention/meta_box_head/res5/block0/conv1/kernel"]).max() > 0
    assert np.abs(grads["visual_attention/rank_loss_classifier/kernel"]).max() > 0


@pytest.fixture(scope="module")
def meta_model():
    cfg = variant_cfg(META)
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(1))
    build_optimizer(cfg, model)
    return model


def test_support_stream_is_backbone_detached(meta_model):
    """The support stream's backbone pass sends no gradient into the
    backbone, the meta head after the pooler learns from the prototypes; and
    the rank losses of a train step reach nothing outside the attention head
    (they read the strong stream's pooled maps detached)."""
    model = meta_model
    model.zero_grad(set_to_none=True)
    att = model.compute_meta_attention({k: t(v) for k, v in support_batch().items()})
    (att.mean ** 2).sum().backward()
    assert all(p.grad is None for p in model.backbone.parameters())
    assert any(p.grad is not None and p.grad.any()
               for p in model.visual_attention.parameters())
    model.zero_grad(set_to_none=True)
    strong, weak = train_batches()
    losses = model.train_losses(torch.Generator().manual_seed(0),
                                {k: t(v) for k, v in strong.items()},
                                {k: t(v) for k, v in weak.items()},
                                meta={k: t(v) for k, v in support_batch().items()})
    torch.stack([losses[k] for k in RANK_KEYS]).sum().backward()
    outside = [n for n, p in model.named_parameters()
               if p.grad is not None and not n.startswith("visual_attention.")]
    assert not outside, outside


def test_rank_loss_takes_the_first_slots_of_each_image(meta_model, monkeypatch):
    """With rank_loss_slots under the sampler's slot count the rank losses
    read the first rank_loss_slots slots of each image (the model above
    covers the other case, 68 slots under 100)."""
    model = meta_model
    monkeypatch.setattr(model, "mc", dataclasses.replace(model.mc, rank_loss_slots=16))
    seen = []
    real = model.visual_attention.rank_loss

    def spy(pooled, gt_classes, valid, *a):
        seen.append((pooled.clone(), gt_classes.clone(), valid.clone()))
        return real(pooled, gt_classes, valid, *a)

    monkeypatch.setattr(model.visual_attention, "rank_loss", spy)
    pooled_all = []
    real_pool = model.pooled_rois

    def pool_spy(feats, boxes):
        out = real_pool(feats, boxes)
        pooled_all.append((out, boxes.shape[1]))
        return out

    monkeypatch.setattr(model, "pooled_rois", pool_spy)
    strong, weak = train_batches()
    with torch.no_grad():
        losses = model.train_losses(torch.Generator().manual_seed(0),
                                    {k: t(v) for k, v in strong.items()},
                                    {k: t(v) for k, v in weak.items()},
                                    meta={k: t(v) for k, v in support_batch().items()})
    (pooled, gt, valid), = seen
    strong_pooled, n_slots = pooled_all[0]
    assert n_slots == 68 and pooled.shape[0] == gt.shape[0] == valid.shape[0] == 2 * 16
    want = strong_pooled.unflatten(0, (2, n_slots))[:, :16].flatten(0, 1)
    assert torch.equal(pooled, want)
    assert all(np.isfinite(float(losses[k])) for k in RANK_KEYS)


# ------------------------------------------------------------------ the support loader
def support_records():
    """Records by class: a class without records, and records whose first
    annotation is of another class (the shot's box is the first of its class)
    or with no box of the class (the whole canvas)."""
    rng = np.random.RandomState(0)
    by_class = {}
    for ci, cls in enumerate(BASE):
        if cls == BASE[4]:
            by_class[cls] = []
            continue
        recs = []
        for i in range(2 + ci % 3):
            h, w = (60, 80) if i % 2 else (80, 60)
            anns = [{"category_id": (cls + 1) % 20, "bbox": [1.0, 2.0, 30.0, 40.0]}]
            if (ci + i) % 4:
                x, y = rng.uniform(0, 20, 2)
                anns.append({"category_id": cls, "bbox": [x, y, x + 25.5, y + 30.25]})
            recs.append({"image_id": f"{cls}_{i}", "height": h, "width": w,
                         "annotations": anns})
        by_class[cls] = recs
    return by_class


@pytest.mark.parametrize("deterministic", [False, True])
def test_support_loader_matches_unit_tpu(deterministic):
    by_class = support_records()

    def make(mod):
        return mod.SupportLoader(by_class, BASE, shots=3, meta_size=48, seed=7,
                                 deterministic=deterministic, image_loader=seeded_image_loader)

    got, want = make(tloader), make(jloader)
    for _ in range(3):
        a, b = got.next_batch(), want.next_batch()
        assert_same_batch(a, b)
    assert not a["class_valid"][4] and not a["image"][4].any() and a["class_valid"].sum() == 14
    assert (a["boxes"] == [0, 0, 48, 48]).all(-1).any()  # a shot without a box of its class
    got.fast_forward(2)
    want.fast_forward(2)
    assert_same_batch(got.next_batch(), want.next_batch())
    # fast_forward skips exactly the batches it is asked to
    fresh, skipped = make(tloader), make(tloader)
    skipped.fast_forward(2)
    for _ in range(2):
        fresh.next_batch()
    assert_same_batch(skipped.next_batch(), fresh.next_batch())


# ------------------------------------------------------------------ trainer, run loop
def test_shipped_meta_yaml_selects_the_meta_trainer():
    tcfg, jcfg = runner.get_cfg(), jget_cfg()
    tcfg.merge_from_file(META)
    jcfg.merge_from_file(META)
    assert tcfg.MODEL.META_ARCHITECTURE == "WeaklySupervisedRCNN"
    assert runner.trainer_name_for(tcfg) == jrunner.trainer_class_for(jcfg).__name__ == "Trainer"
    assert runner.trainer_class_for(tcfg) is Trainer


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"))


def run_meta(devkit, out, monkeypatch, *flags, opts=()):
    """runner.run of the meta recipe at the tiny size -> (results, trainer,
    support batches of the evaluations)."""
    made, evaluated = [], []

    class Recording(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    real = runner.meta_attention

    def spy(*a, **kw):
        att = real(*a, **kw)
        evaluated.append(att)
        return att

    monkeypatch.setattr(runner, "Trainer", Recording)
    monkeypatch.setattr(runner, "meta_attention", spy)
    tdata.DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args(
        ["--config-file", META, "--device", "cpu", "--data-root", devkit, *flags, *TINY,
         "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out),
         "INPUT.META_MIN_SIZE", "64", "DATASETS.FEWSHOT.NUM_SHOTS", "2",
         "DATASETS.BASE_META_SHOTS", "2", "SOLVER.MAX_ITER", "2",
         "SOLVER.CHECKPOINT_PERIOD", "1", "TEST.EVAL_PERIOD", "0", *opts])
    results = runner.run(args, image_loader=seeded_image_loader)
    return results, made[-1], evaluated


def test_meta_run_steps_evaluates_and_resumes(devkit, tmp_path, monkeypatch):
    """Two Trainer steps with the three streams and a checkpoint a step, the
    evaluation through the meta evaluation loop with prototypes of BASE_META_SHOTS
    shots a class, then a run resumed from step 1 that repeats step 2's
    losses and the evaluation exactly (the support stream fast-forwarded)."""
    calls = []
    real_loop = runner.inference_on_dataset_meta

    def meta_loop(*a, **kw):
        calls.append(1)
        return real_loop(*a, **kw)

    monkeypatch.setattr(runner, "inference_on_dataset_meta", meta_loop)
    out_a = tmp_path / "a"
    results, trainer, evaluated = run_meta(devkit, out_a, monkeypatch)
    assert trainer.meta_iter is not None and trainer.state.step == 2
    assert not trainer.meta_iter.thread.is_alive()  # run() closed the three streams
    for m in trainer.metrics_history:
        assert RANK_KEYS | RPN_KEYS | OICR_KEYS <= set(m)
        assert all(np.isfinite(v) for v in m.values())
    assert all(np.isfinite(results["bbox"][k]) for k in ("AP", "AP50", "AP75"))
    (att,) = evaluated
    assert calls == [1] and att.mean.shape == (21, 128)
    assert int(torch.isfinite(att.logdet).sum()) == 16
    out_b = tmp_path / "b"
    os.makedirs(out_b)
    shutil.copy(out_a / "step_1.pt", out_b)
    results_b, resumed, _ = run_meta(devkit, out_b, monkeypatch, "--resume")
    assert resumed.state.step == 2 and len(resumed.metrics_history) == 1
    strip = lambda m: {k: v for k, v in m.items() if k != "data_time"}  # noqa: E731
    assert strip(resumed.metrics_history[0]) == strip(trainer.metrics_history[1])
    assert results_b["bbox"] == results["bbox"]


def test_meta_eval_skips_the_prototypes_without_a_support_dataset(meta_model, monkeypatch):
    warnings = []
    monkeypatch.setattr(runner.logger, "warning", lambda *a: warnings.append(a[0] % a[1:]))
    tdata.DatasetCatalog.clear()
    assert runner.meta_attention(variant_cfg(META), meta_model) is None
    assert warnings and "voc_base_training_support not registered" in warnings[0]


# ------------------------------------------------------------------ the meta evaluation loop
class _Det:
    def __init__(self, b, sc, c, v):
        self.boxes, self.scores, self.classes, self.valid, self.masks = b, sc, c, v, None


def _predict(att, imgs, sizes):
    assert att is not None and "proto" in att
    b = imgs.shape[0]
    return _Det(torch.tensor([[[10.0, 10, 50, 50]]]).repeat(b, 1, 1),
                torch.full((b, 1), 0.9), torch.zeros((b, 1), dtype=torch.int64),
                torch.ones((b, 1), dtype=torch.bool))


def _batches():
    return [{"image": np.zeros((1, 8, 8, 3)), "image_size": np.asarray([[8.0, 8.0]]),
             "image_id": [f"i{k}"], "scale": [1.0], "orig_size": [(100, 100)]}
            for k in range(3)]


def _evaluator(cls=PascalVOCEvaluator):
    ev = cls(["a"], use_07_metric=False)
    for k in range(3):
        ev.process_gt_record({"image_id": f"i{k}",
                              "annotations": [{"category_id": 0, "bbox": [10, 10, 50, 50]}]})
    return ev


def test_meta_eval_loop_binds_attention_and_scores():
    res = inference_on_dataset_meta(_predict, iter(_batches()),
                                    {"proto": np.ones((3, 4), np.float32)}, _evaluator(),
                                    total_images=3)
    assert res["bbox"]["AP50"] == 100.0


def test_meta_eval_loop_matches_plain_loop_and_is_attention_invariant():
    """Equal to the plain loop whatever the attention, and to unit_tpu's
    evaluator on the same detections."""
    r_meta1 = inference_on_dataset_meta(_predict, iter(_batches()), {"proto": np.zeros((3, 4))},
                                        _evaluator(), total_images=3)
    r_meta2 = inference_on_dataset_meta(_predict, iter(_batches()),
                                        {"proto": 99 + np.ones((5, 2))}, _evaluator(),
                                        total_images=3)
    r_plain = inference_on_dataset(lambda im, sz: _predict({"proto": 0}, im, sz),
                                   iter(_batches()), _evaluator(), total_images=3)
    ev = _evaluator(JPascalVOCEvaluator)
    for k in range(3):
        ev.process(f"i{k}", np.asarray([[10.0, 10, 50, 50]]), np.asarray([0.9]),
                   np.zeros(1, np.int32), np.ones(1, bool))
    r_jax = ev.evaluate()
    for key in ("AP", "AP50", "AP75"):
        assert (r_meta1["bbox"][key] == r_meta2["bbox"][key] == r_plain["bbox"][key]
                == r_jax["bbox"][key])


# ------------------------------------------------------------------ heads, solver
def test_fine_tune_meta_heads_build_and_carry_their_parameters():
    """The fine-tune meta heads (WSROIHeadFineTuneMeta: the attention head
    beside the *_ft heads) build, and their parameters and buffers are
    unit_tpu's leaf for leaf (load_jax_params is strict both ways); so are
    those of the other three attention modes.  Both packages' registry check
    refuses the name WSROIHeadFineTuneMeta in a config, so the heads are
    built from the fine-tune recipe's ModelConfig with ``use_meta`` set, as
    that name would set it."""
    ft = ("MODEL.ROI_HEADS.NAME", "WSROIHeadFineTune",
          "MODEL.ROI_HEADS.FAST_RCNN.NAME", "SupervisedDetectorOutputsFineTune")
    for opts in (ft, *(("MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME", name) for name in (
            "MeanMatrixSimilarity", "MeanMatrixSimilarityLocatron", "MahalanobisSimilarity"))):
        cfg = variant_cfg(META, *opts)
        jmc = dataclasses.replace(JModelConfig.from_cfg(cfg), use_meta=True)
        tmc = dataclasses.replace(ModelConfig.from_cfg(cfg), use_meta=True)
        shapes = jax.eval_shape(JWSRCNN(mc=jmc).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 160, 224, 3)),
                                jnp.asarray([[160.0, 224.0]]))["params"]
        tm = WSRCNN(tmc)
        assert tm.mc.finetune == (opts is ft) and isinstance(tm.visual_attention,
                                                             torch.nn.Module)
        load_jax_params(tm, jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes))
        flat = flatten_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
        assert {k for k in flat if k.startswith("visual_attention/")
                and "_bn/" not in k} == {k for k in flax_leaves(tm)
                                         if k.startswith("visual_attention/")}
    for get, mc_cls in ((jget_cfg, JModelConfig), (runner.get_cfg, ModelConfig)):
        cfg = get()
        cfg.merge_from_file(META)
        cfg.MODEL.ROI_HEADS.NAME = "WSROIHeadFineTuneMeta"
        with pytest.raises(KeyError, match="WSROIHeadFineTuneMeta"):
            mc_cls.from_cfg(cfg)


def test_solver_groups_follow_unit_tpu_on_the_meta_model(meta_model):
    """Every parameter's LR factor and freezing as unit_tpu's build_optimizer
    decides them: the meta head's FrozenBN frozen (buffers here, frozen
    params there), the rank classifier's bias at BIAS_LR_FACTOR, the rest of
    the head at 1."""
    cfg = variant_cfg(META, "SOLVER.BIAS_LR_FACTOR", "2.0")
    solver = build_optimizer(cfg, meta_model)
    factor = {id(p): g["initial_lr"] / cfg.SOLVER.BASE_LR for g in solver.optimizer.param_groups
              for p in g["params"]}
    seen = 0
    for name, param in meta_model.named_parameters():
        path = flax_path(name, param)
        assert (id(param) not in factor) == jis_frozen(path, cfg), path
        if id(param) in factor:
            assert factor[id(param)] == pytest.approx(jlr_factor_for(path, cfg)), path
        if path.startswith("visual_attention/"):
            seen += 1
            want = 2.0 if path == "visual_attention/rank_loss_classifier/bias" else 1.0
            assert factor[id(param)] == pytest.approx(want), path
    assert seen == len(list(meta_model.visual_attention.parameters())) > 0
    for name, _ in meta_model.visual_attention.named_buffers():
        assert jis_frozen("visual_attention/" + name.replace(".", "/"), cfg), name
