"""The paths a shipped recipe reaches with two keys changed: unit_tpu_torch vs unit_tpu.

The note recipe (configs/COCO/COCO-RCNN-50-C4-split1-note.yaml:
InceptionResNetV2 + InceptionResNetHead, 80 classes, ROIAlignV2 at 17x17)
with MODEL.MASK_ON and the mask ROI heads, as the R-50 segm recipe sets
them: the mask head reads the tail's [N, 8, 8, 1536] map before its spatial
mean, so masks are 16 x 16.  Held on shared weights at
tests/test_torch_pairs.py's size and bounds: a train step's losses and every
gradient, predict_raw and predict with masks, TrainerNoMeta's step, the
artifact against the live predict, the segm evaluation on a shapes-COCO
devkit; and masks over a VGG fc head, refused in both packages.  The path
tests here run on the note and the dock with the meta stream in
tests/test_torch_pair_meta.py, which takes them with this module's cached
paths (``path_data``).
"""

import functools
import itertools
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu_torch.data as tdata
import unit_tpu_torch.data.utils as tutils
from tests.test_torch_data import seeded_image_loader
from tests.test_torch_dock_data import link_2014
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from tests.test_torch_pairs import (
    BOX_TOL,
    DOCK,
    MASK_TOL,
    MASKS,
    META_KEYS,
    NOTE,
    PROB_TOL,
    H,
    W,
    assert_gradients_match,
    assert_losses_match,
    batches,
    both_cfgs,
    jax_train,
    make_pair,
    reduced_inception,  # noqa: F401  (autouse)
    support_batch,
    t,
    torch_train,
)
from unit_tpu.data.utils import register_datasets as jregister_datasets
from unit_tpu.evaluation.coco_eval import COCOEvaluator as JCOCOEvaluator
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.data.utils import register_datasets
from unit_tpu_torch.engine import runner
from unit_tpu_torch.engine.predict import make_predict_fn
from unit_tpu_torch.engine.train import Trainer, TrainerNoMeta
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.serving import export_predict, load_exported
from unit_tpu_torch.solver import build_optimizer

SHAPES = runpy.run_path("scripts/make_shapes_coco_torch.py")
PROPOSALS = runpy.run_path("scripts/make_shapes_proposals_torch.py")

def spread(params):
    """The tree with the class predictors' kernels x1000: random heads give
    each of 81 classes ~1/81, and final detections of near-ties are ordered
    by float noise; spread, every detection has a counterpart."""
    out = jax.tree.map(np.asarray, params)
    for group, heads in (("supervised", ("cls_score_delta",)),
                         ("weak_detector", tuple(k for k in out["weak_detector"]
                                                 if k.startswith("oicr_predictor")))):
        for head in heads:
            out[group][head] = dict(out[group][head], kernel=out[group][head]["kernel"] * 1e3)
    return out


def predict_inputs(strong):
    images = strong["image"].copy()
    images[1, H - 8:], images[1, :, W - 16:] = 0.0, 0.0
    given = {k: strong[k] for k in ("proposals", "proposals_valid") if k in strong}
    return images, strong["image_size"], given


def torch_predict_raw(tm, images, sizes, given):
    tm.eval()
    with torch.inference_mode():
        out = tm.predict_raw(t(images), t(sizes), *(t(given[k]) for k in
                                                    ("proposals", "proposals_valid")
                                                    if k in given))[:3]
    tm.train()
    return out


def assert_raw_match(raw_j, raw_t):
    (pj, bj, prj), (pt, bt, prt) = raw_j, raw_t
    np.testing.assert_array_equal(prt.valid.numpy(), prj.valid)
    valid = prj.valid
    assert valid.sum() > 0
    np.testing.assert_allclose(prt.boxes.numpy()[valid], prj.boxes[valid], atol=BOX_TOL)
    np.testing.assert_allclose(pt.numpy()[valid], pj[valid], atol=PROB_TOL)
    np.testing.assert_allclose(bt.numpy()[valid], bj[valid], atol=PROB_TOL)


# ------------------------------------------------------- the recipes' paths
PATHS = {
    "note_masks": (NOTE, MASKS),
    "note_meta": (NOTE, META_KEYS),
    "dock_meta": (DOCK, META_KEYS),
}


@functools.lru_cache(maxsize=None)
def path_data(case):
    """One recipe path on one seeded flax tree: each side's losses and
    gradients of a train step (with a support batch where the path has the
    meta stream), and the models and inputs for predict.  Cached: the tests
    that take a subset of the paths share it."""
    yaml, opts = PATHS[case]
    jcfg, tcfg = both_cfgs(yaml, *opts)
    jm, params, tm = make_pair(jcfg, tcfg)
    strong, weak = batches(tcfg)
    meta = support_batch(tcfg) if tm.mc.use_meta else None
    out = dict(case=case, jcfg=jcfg, tcfg=tcfg, jm=jm, params=params, tm=tm,
               strong=strong, weak=weak, meta=meta)
    out["jax"] = jax_train(jm, params, strong, weak, meta)
    out["torch"] = torch_train(tm, strong, weak, meta)
    return out


@pytest.fixture(scope="module", autouse=True)
def release_paths():
    """The cached models and gradients go with the module."""
    yield
    path_data.cache_clear()


@pytest.fixture(scope="module", params=["note_masks"])
def path(request):
    """The note + masks path here; the meta paths take this module's
    path tests in tests/test_torch_pair_meta.py."""
    return path_data(request.param)


def test_path_builds_over_the_backbones_width(path):
    tm, case = path["tm"], path["case"]
    c = tm.backbone.out_channels
    assert c == (256 if case == "dock_meta" else 1088)
    if tm.mc.use_meta:
        block0 = tm.visual_attention.meta_box_head.res5.block0
        assert block0.conv1.weight.shape[1] == block0.shortcut.weight.shape[1] == c
        assert tm.visual_attention.pooler_resolution == tm.mc.pooler_resolution
    if tm.mc.mask_on:
        assert tm.mask_head.deconv.weight.shape[0] == tm.box_head.out_channels == 1536
    jmc = JModelConfig.from_cfg(path["jcfg"])
    for f in ("use_meta", "mask_on", "pooler_resolution", "pooler_scale", "pooler_type",
              "backbone_name", "box_head_name", "mask_fg_slots"):
        assert getattr(tm.mc, f) == getattr(jmc, f), f


def test_path_train_losses_match(path):
    (want, _), (got, _) = path["jax"], path["torch"]
    keys = {"loss_cls", "loss_box_reg", "loss_im_cls", "loss_oicr_3"}
    if path["tm"].mc.mask_on:
        keys |= {"loss_mask"}
    if path["tm"].mc.use_meta:
        keys |= {"loss_rank_margin", "loss_rank_reg", "loss_rank_cls"}
    assert_losses_match(want, got, keys)


def test_path_train_gradients_match(path):
    mc = path["tm"].mc
    trained = ["backbone/", "box_head/"]
    if mc.mask_on:
        trained.append("mask_head/")
    if mc.use_meta:
        trained += ["visual_attention/meta_box_head/", "visual_attention/rank_loss_classifier/"]
    assert_gradients_match(path["jcfg"], path["jax"][1], path["torch"][1], trained)


def test_path_predict_matches(path):
    """predict_raw, then predict's final detections and, with masks, their
    16 x 16 masks (the tail's 8 x 8 map, the deconv doubling it)."""
    jm, tm = path["jm"], path["tm"]
    params = spread(path["params"])
    load_jax_params(tm, params)
    images, sizes, given = predict_inputs(path["strong"])
    kw = {} if not given else dict(proposal_boxes=jnp.asarray(given["proposals"]),
                                   proposal_valid=jnp.asarray(given["proposals_valid"]))

    def both(model, i, s):  # one program: predict_raw's outputs and predict's
        return model.predict_raw(i, s, **kw)[:3], model.predict(i, s, **kw)

    raw_j, dj = jax.tree.map(np.asarray, jax.jit(lambda p, i, s: jm.apply(
        {"params": p}, i, s, method=both))(params, jnp.asarray(images), jnp.asarray(sizes)))
    assert_raw_match(raw_j, torch_predict_raw(tm, images, sizes, given))
    tm.eval()
    with torch.inference_mode():
        dt = tm.predict(t(images), t(sizes), *(t(given[k]) for k in
                                               ("proposals", "proposals_valid") if k in given))
    tm.train()
    if tm.mc.mask_on:
        assert dt.masks.shape == dj.masks.shape == dt.boxes.shape[:2] + (16, 16)
    n = 0
    for i in range(2):
        want = np.flatnonzero(dj.valid[i])
        got = np.flatnonzero(dt.valid[i].numpy())
        assert len(got) == len(want) > 0
        for k in want:
            match = [m for m in got if int(dt.classes[i, m]) == int(dj.classes[i, k])
                     and abs(float(dt.scores[i, m]) - float(dj.scores[i, k])) < PROB_TOL
                     and np.abs(dt.boxes[i, m].numpy() - dj.boxes[i, k]).max() < BOX_TOL]
            assert match, (i, k)
            if tm.mc.mask_on:
                diff = np.abs(dt.masks[i, match[0]].numpy() - dj.masks[i, k]).max()
                assert diff <= MASK_TOL, (i, k, diff)
            n += 1
    assert n >= 8


# ------------------------------------------------------ trainers and artifacts
def test_trainers_take_the_paths_streams(path):
    """The note + masks path under TrainerNoMeta (gt_masks in the strong
    batches), the meta paths under Trainer with a support batch a step (the
    dock's beside its precomputed proposals, its VGG head's dropout on): a
    step each, every loss finite, the mask and rank losses among them, the
    heads updated."""
    tcfg, tm = path["tcfg"], WSRCNN(path["tm"].mc, generator=torch.Generator().manual_seed(0))
    strong, weak = batches(tcfg, seed=5)
    solver = build_optimizer(tcfg, tm)
    streams = dict(strong_iter=itertools.repeat(strong), weak_iter=itertools.repeat(weak))
    if tm.mc.use_meta:
        trainer = Trainer(tm, solver, meta_iter=itertools.repeat(support_batch(tcfg)), seed=0,
                          **streams)
    else:
        trainer = TrainerNoMeta(tm, solver, seed=0, **streams)
    assert trainer.dropout == (path["case"] == "dock_meta")
    trainer.init_state()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    m = dict(trainer.run_step().resolve())
    assert all(np.isfinite(v) for v in m.values()), m
    assert ("loss_mask" in m) == tm.mc.mask_on
    assert ("loss_rank_cls" in m) == tm.mc.use_meta
    moved = {k.split(".")[0] for k, v in tm.state_dict().items() if not torch.equal(v, before[k])}
    assert {"box_head", "visual_attention" if tm.mc.use_meta else "mask_head"} <= moved


def test_artifact_matches_the_live_predict(path, tmp_path):
    check_artifact(path, tmp_path)


def check_artifact(path, tmp_path):
    """torch.export artifacts of the note with masks and of the dock's meta
    model (its attention head in the program's state; inference reads none
    of it) on one 128 x 128 canvas, against the live predict."""
    opts = ["INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "128"]
    if path["case"] == "dock_meta":
        opts += ["DATASETS.PROPOSAL_FILES_TEST", "('p.pkl',)",
                 "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "8"]
    cfg = path["tcfg"].clone()
    cfg.merge_from_list(opts)
    tm = load_jax_params(WSRCNN(ModelConfig.from_cfg(cfg)), spread(path["params"])).eval()
    meta = export_predict(cfg, tm, str(tmp_path / "a.pkl"))
    artifact = load_exported(str(tmp_path / "a.pkl"))
    images = np.random.RandomState(6).uniform(0, 255, (1, 128, 128, 3)).astype(np.float32)
    sizes = np.asarray([[128.0, 120.0]], np.float32)
    extra = ()
    if meta["with_proposals"]:
        extra = (path["strong"]["proposals"][:1] * 0.8, path["strong"]["proposals_valid"][:1])
    got, want = artifact(images, sizes, *extra), make_predict_fn(tm)(images, sizes, *extra)
    v = want.valid.numpy()
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    for k in ("classes", "boxes", "scores") + (("masks",) if tm.mc.mask_on else ()):
        np.testing.assert_allclose(getattr(got, k).numpy()[v], getattr(want, k).numpy()[v],
                                   rtol=1e-6, atol=1e-5, err_msg=k)


# ------------------------------------------------------------- refused in both
def test_masks_over_a_vgg_fc_head_are_refused_in_both_packages():
    """The VGG fc heads flatten each ROI (unit_tpu's return [N, 4096]
    whatever spatial_mean says), so the mask head has no map: unit_tpu's
    init fails in its mask head, the port refuses the config."""
    jcfg, tcfg = both_cfgs(DOCK, *MASKS)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    with pytest.raises(Exception) as failure:
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                       jnp.asarray([[H, W]], jnp.float32))
    assert "mask_head" in "".join(str(f) for f in failure.traceback)
    with pytest.raises(ValueError, match="has none"):
        WSRCNN(ModelConfig.from_cfg(tcfg))
    with pytest.raises(ValueError, match="no spatial map"), torch.no_grad():
        vgg = WSRCNN(ModelConfig.from_cfg(both_cfgs(DOCK)[1]))
        vgg.box_head(torch.zeros(1, 6, 6, 256), spatial_mean=False)


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    """A shapes-COCO devkit with the dock suite's 2014 names and proposal
    files."""
    root = str(tmp_path_factory.mktemp("shapes_coco"))
    SHAPES["write_shapes_coco"](root, train_images=12, val_images=4, size=96, seed=7)
    link_2014(root)
    PROPOSALS["write_proposals"](root, ("train2014", "val2014"), per_image=20, seed=11)
    return root


def suite_cfgs(yaml, devkit, *opts):
    jcfg, tcfg = both_cfgs(yaml, "DATASETS.CLASSIFIER_DATAROOT", devkit,
                           "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "160",
                           "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
                           "INPUT.META_MIN_SIZE", str(64), "DATASETS.BASE_META_SHOTS", "2",
                           "MODEL.ROI_HEADS.EMBEDDING_PATH", "", *opts)
    jdata.DatasetCatalog.clear()
    tdata.DatasetCatalog.clear()
    jregister_datasets(jcfg, devkit)
    register_datasets(tcfg, devkit)
    return jcfg, tcfg


def test_note_with_masks_evaluates_as_unit_tpu_does(devkit, monkeypatch):
    """The port's make_eval_fn on the note + masks model (carried weights,
    the predictors spread) over the devkit's val images; its detections and
    16 x 16 masks are held to unit_tpu's by test_path_predict_matches.  What
    it feeds its bbox and segm evaluators, replayed into unit_tpu's
    COCOEvaluator, gives the same stats, and the segm AP is not trivial."""
    _, tcfg = suite_cfgs(NOTE, devkit, *MASKS)
    tm = load_jax_params(WSRCNN(ModelConfig.from_cfg(tcfg)), spread(path_data("note_masks")[
        "params"])).eval()
    made = []

    class Recording(tutils.COCOEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            made.append((a, kw, self))

        def process_gt_record(self, record):
            self.calls.append(("process_gt_record", (record,), {}))
            super().process_gt_record(record)

        def process(self, *a, **kw):
            self.calls.append(("process", a, kw))
            super().process(*a, **kw)

    monkeypatch.setattr(tutils, "COCOEvaluator", Recording)
    got = runner.make_eval_fn(tcfg, tm, image_loader=seeded_image_loader)(tm)
    assert sorted(e.iou_type for _, _, e in made) == ["bbox", "segm"]
    for a, kw, ev in made:
        masks = [c[2]["masks"] for c in ev.calls if c[0] == "process"]
        assert masks and all(m.shape[1:] == (16, 16) for m in masks)
        replay = JCOCOEvaluator(*a, **kw)
        for name, args, kwargs in ev.calls:
            getattr(replay, name)(*args, **kwargs)
        want = replay.evaluate()[ev.iou_type]
        for k in ("AP", "AP50", "AP75", "novel_mean"):
            assert np.isfinite(want[k]), (ev.iou_type, k)
            np.testing.assert_allclose(got[ev.iou_type][k], want[k], atol=1e-9,
                                       err_msg=f"{ev.iou_type} {k}")
    assert got["segm"]["AP50"] > 0
