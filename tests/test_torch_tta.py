"""Test-time augmentation (TEST.AUG): unit_tpu_torch vs unit_tpu.

The models are the flagship recipe cut to depth 26, RES2_OUT_CHANNELS 16, a
96 x 160 canonical canvas and 64 proposals, in f32, with TEST.AUG cut to the
scales (64, 80) on MAX_SIZE 160 with FLIP: two groups of a flip pair each.
Random flax weights go through load_jax_params.  unit_tpu's predict_tta runs
under jit as its runner runs it (its ROIAlign and NMS are the XLA versions on
the CPU); the port's kernels are their plain versions here.

Bounds, each with its reason:
  * the canvases, the loader's images, sizes, scales and flips: exact (numpy
    on both sides, the same resize);
  * canonical proposals: the same valid slots, boxes within 1e-3 px (the
    backbone's f32 convolutions differ in summation order, ~1e-5 px here);
  * final detections: the same classes and valid slots, boxes within 1e-3 px
    and scores (sums of up to four probabilities) within 1e-4 relative;
  * the runner's evaluation: each evaluator fed the same detections (the
    bounds above, in original-image pixels, up to the order of scores that tie
    within them) and the same AP, to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu.data.loader as jloader
import unit_tpu_torch.data as tdata
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import assert_same_batch, seeded_image_loader, write_devkit
from tests.test_torch_finetune import BOTH_FT, FT_YAML
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.data.transforms import max_aspect_of as jmax_aspect_of
from unit_tpu.data.transforms import tta_canvas_for as jtta_canvas_for
from unit_tpu.engine import runner as jrunner
from unit_tpu.evaluation import PascalVOCEvaluator as JPascalVOCEvaluator
from unit_tpu.models import rpn as jrpn
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu_torch.checkpoint import Checkpointer, load_jax_params
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data.loader import prepare_tta_batch, tta_variant_configs
from unit_tpu_torch.data.transforms import TransformConfig, max_aspect_of, tta_canvas_for
from unit_tpu_torch.engine import runner
from unit_tpu_torch.engine.train import TrainState
from unit_tpu_torch.evaluation import PascalVOCEvaluator
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

FLAGSHIP = "configs/VOC/VOC-RCNN-101-C4-split1.yaml"
META = "configs/VOC/VOC-RCNN-101-C4-split1-meta.yaml"
SMALL = [
    "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "600", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
    "TPU.COMPUTE_DTYPE", "float32",
    "TEST.AUG.MIN_SIZES", "(64, 80)", "TEST.AUG.MAX_SIZE", "160", "TEST.AUG.FLIP", "True",
]
BOX_TOL = 1e-3
SCORE_RTOL = 1e-4


def both_cfgs(path, *opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(path)
        cfg.merge_from_list(list(opts))
    return jcfg, tcfg


def make_pair(path, *opts):
    jcfg, tcfg = both_cfgs(path, *SMALL, *opts)
    jmodel = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                     jnp.asarray([[64.0, 64.0]]))
    params = randomize_params(variables["params"], seed=3)
    tmodel = WSRCNN(ModelConfig.from_cfg(tcfg)).eval()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return tcfg, jmodel, params, tmodel


@pytest.fixture(scope="module")
def pair():
    return make_pair(FLAGSHIP)


@pytest.fixture(scope="module")
def ft_pair():
    return make_pair(FT_YAML, *BOTH_FT)


# ----------------------------------------------------------------- canvases
@pytest.mark.parametrize("min_size", [64, 480, 688, 1200])
@pytest.mark.parametrize("max_aspect", [1.0, 4 / 3, 1.7778, 3.5])
@pytest.mark.parametrize("divisibility", [1, 32])
def test_tta_canvas_for_matches(min_size, max_aspect, divisibility):
    for max_size in (160, 1333, 2000):
        assert tta_canvas_for(min_size, max_size, divisibility, max_aspect) == \
            jtta_canvas_for(min_size, max_size, divisibility, max_aspect)


def test_max_aspect_of_matches():
    rng = np.random.RandomState(0)
    records = [{"height": int(h), "width": int(w)} for h, w in rng.randint(1, 900, (40, 2))]
    records += [{"height": 0, "width": 30}, {"file_name": "x"}]
    assert max_aspect_of(records) == jmax_aspect_of(records)
    assert max_aspect_of([]) == jmax_aspect_of([]) == 1.0


# ----------------------------------------------------------------- the loader
@pytest.mark.parametrize("flip", [True, False])
def test_tta_loader_matches(tmp_path, flip):
    # landscape and portrait at an aspect whose two scales get distinct canvases
    root = write_devkit(tmp_path / "VOCdevkit", n_images=4, sizes=((90, 150), (150, 90)))
    opts = [*SMALL, "TEST.AUG.FLIP", str(flip)]
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    jcfg, tcfg = both_cfgs(FLAGSHIP, *opts, "DATASETS.CLASSIFIER_DATAROOT", root)
    tdata.RegisterVOC(tcfg, root).register_all()
    jdata.RegisterVOC(jcfg, root).register_all()
    name = tcfg.DATASETS.TEST[0]
    tl, tn = tdata.build_tta_test_loader(tcfg, name, image_loader=seeded_image_loader)
    jl, jn = jloader.build_tta_test_loader(jcfg, name, image_loader=seeded_image_loader)
    try:
        got, want = list(tl), list(jl)
    finally:
        tl.close()
    assert tn == jn == 4 and len(got) == len(want) == 4
    shapes = set()
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        assert len(g["variants"]) == len(w["variants"]) == (4 if flip else 2)
        assert_same_batch({k: v for k, v in g.items() if k not in ("image_id", "variants")},
                          {k: v for k, v in w.items() if k not in ("image_id", "variants")})
        for gv, wv in zip(g["variants"], w["variants"]):
            assert gv["flip"] == wv["flip"] and gv["scale"] == wv["scale"]
            assert_same_batch({k: gv[k] for k in ("image", "image_size")},
                              {k: wv[k] for k in ("image", "image_size")})
            shapes.add(gv["image"].shape)
        if flip:  # the twin mirrors the content only; the padding stays zero
            v, vf = g["variants"][0], g["variants"][1]
            nh, nw = (int(s) for s in v["image_size"][0])
            np.testing.assert_array_equal(vf["image"][0, :nh, :nw],
                                          v["image"][0, :nh, :nw][:, ::-1])
            assert not vf["image"][0, nh:].any() and not vf["image"][0, :, nw:].any()
    assert len(shapes) == 4  # two scales in both orientations
    assert not tl.thread.is_alive()


# ----------------------------------------------------------------- predict_tta
def tta_inputs(tcfg, variant_set):
    img = np.random.RandomState(1).uniform(0, 255, (90, 120, 3)).astype(np.float32)
    batch = prepare_tta_batch({"image_id": "x"}, img, TransformConfig.test_from_cfg(tcfg),
                              tta_variant_configs(tcfg, 120 / 90))
    if variant_set != "two scales x flip":
        one = {"image": batch["image"], "image_size": batch["image_size"], "scale": 1.0,
               "flip": False}
        batch["variants"] = [one] * (1 if variant_set == "identity" else 2)
    return batch


def jax_proposals(module, image, image_size):
    feats = module.features(image)
    logits, deltas = module.rpn(feats)
    anchors = jrpn.get_anchors(feats.shape[1], feats.shape[2], module.mc.rpn)
    return jrpn.select_proposals(logits, deltas, anchors, image_size, module.mc.rpn,
                                 training=False)


def jax_tta(jmodel, params, batch, with_transfer, tta_topk):
    """unit_tpu's predict_tta under jit, as its runner's tta_fn calls it (the
    flips are constants, the scales traced), and its canonical proposals."""
    flips = [v["flip"] for v in batch["variants"]]

    @jax.jit
    def tta_fn(params, image, image_size, var_arrays):
        variants = [{"image": im, "image_size": sz, "scale": sc, "flip": fl}
                    for (im, sz, sc), fl in zip(var_arrays, flips)]
        dets = jmodel.apply({"params": params}, image, image_size, variants,
                            with_transfer=with_transfer, tta_topk=tta_topk,
                            method=JWSRCNN.predict_tta)
        return dets, jmodel.apply({"params": params}, image, image_size, method=jax_proposals)

    var_arrays = [(jnp.asarray(v["image"]), jnp.asarray(v["image_size"]), np.float32(v["scale"]))
                  for v in batch["variants"]]
    return tta_fn(params, jnp.asarray(batch["image"]), jnp.asarray(batch["image_size"]),
                  var_arrays)


def run_both(jmodel, params, tmodel, batch, with_transfer=True, tta_topk=0):
    dj, pj = jax_tta(jmodel, params, batch, with_transfer, tta_topk)
    tvars = [{"image": torch.as_tensor(v["image"]), "image_size": torch.as_tensor(v["image_size"]),
              "scale": v["scale"], "flip": v["flip"]} for v in batch["variants"]]
    args = (torch.as_tensor(batch["image"]), torch.as_tensor(batch["image_size"]), tvars)
    with torch.inference_mode():
        _, _, pt = tmodel.predict_tta_raw(*args, with_transfer=with_transfer, tta_topk=tta_topk)
        dt = tmodel.predict_tta(*args, with_transfer=with_transfer, tta_topk=tta_topk)
    return dj, pj, dt, pt


def assert_same_detections(dj, dt):
    valid = np.asarray(dj.valid)
    np.testing.assert_array_equal(dt.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(dt.classes.numpy()[valid], np.asarray(dj.classes)[valid])
    db = np.abs(dt.boxes.numpy()[valid] - np.asarray(dj.boxes)[valid]).max()
    assert db <= BOX_TOL, db
    np.testing.assert_allclose(dt.scores.numpy()[valid], np.asarray(dj.scores)[valid],
                               rtol=SCORE_RTOL)


def assert_same_proposals(pj, pt, topk=0):
    boxes, valid = np.asarray(pj.boxes), np.asarray(pj.valid)
    if topk:  # lax.top_k on unit_tpu's proposals: ties keep the lower index first
        score = np.where(valid, np.asarray(pj.objectness), -np.inf)
        idx = np.asarray(jax.lax.top_k(jnp.asarray(score), topk)[1])
        boxes = np.take_along_axis(boxes, idx[..., None], axis=1)
        valid = np.take_along_axis(valid, idx, axis=1)
    np.testing.assert_array_equal(pt.valid.numpy(), valid)
    assert np.abs(pt.boxes.numpy() - boxes)[valid].max() <= BOX_TOL


@pytest.mark.parametrize("variant_set", ["identity", "two identical", "two scales x flip"])
def test_predict_tta_matches(pair, variant_set):
    tcfg, jmodel, params, tmodel = pair
    batch = tta_inputs(tcfg, variant_set)
    dj, pj, dt, pt = run_both(jmodel, params, tmodel, batch)
    assert_same_proposals(pj, pt)
    assert_same_detections(dj, dt)


def test_predict_tta_without_transfer_matches(pair):
    tcfg, jmodel, params, tmodel = pair
    dj, pj, dt, pt = run_both(jmodel, params, tmodel, tta_inputs(tcfg, "two scales x flip"),
                              with_transfer=False)
    assert_same_detections(dj, dt)


def test_predict_tta_topk_matches_and_breaks_ties_by_index(pair):
    tcfg, jmodel, params, tmodel = pair
    batch = tta_inputs(tcfg, "two scales x flip")
    dj, pj, dt, pt = run_both(jmodel, params, tmodel, batch, tta_topk=16)
    assert pt.boxes.shape[1] == 16
    assert_same_proposals(pj, pt, topk=16)
    assert_same_detections(dj, dt)
    # fewer valid proposals than K: the -inf ties are taken in index order
    with torch.inference_mode():
        valid = torch.zeros(1, 64, dtype=torch.bool)
        valid[0, [3, 7, 40]] = True
        score = torch.where(valid, torch.arange(64.0), -torch.inf)
    idx = torch.sort(score, dim=1, descending=True, stable=True)[1][:, :8]
    want = np.asarray(jax.lax.top_k(jnp.asarray(score.numpy()), 8)[1])
    np.testing.assert_array_equal(idx.numpy(), want)


def test_predict_tta_fine_tune_terms_match(ft_pair):
    tcfg, jmodel, params, tmodel = ft_pair
    assert tmodel.mc.finetune
    dj, pj, dt, pt = run_both(jmodel, params, tmodel, tta_inputs(tcfg, "two scales x flip"))
    assert_same_detections(dj, dt)


def test_predict_tta_twin_variants_double_the_probabilities(pair):
    tcfg, _, _, tmodel = pair
    one, two = tta_inputs(tcfg, "identity"), tta_inputs(tcfg, "two identical")

    def raw(batch):
        tvars = [{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                  for k, v in var.items()} for var in batch["variants"]]
        with torch.inference_mode():
            return tmodel.predict_tta_raw(torch.as_tensor(batch["image"]),
                                          torch.as_tensor(batch["image_size"]), tvars)

    (p1, d1, _), (p2, d2, _) = raw(one), raw(two)
    torch.testing.assert_close(p2, 2 * p1, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(d2, d1, rtol=1e-6, atol=1e-7)
    with torch.inference_mode():
        probs, bbox, _, _ = tmodel.predict_raw(torch.as_tensor(one["image"]),
                                               torch.as_tensor(one["image_size"]))
    torch.testing.assert_close(p1, probs, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(d1, bbox, rtol=1e-6, atol=1e-7)


def test_predict_tta_with_precomputed_proposals_raises(pair):
    """Precomputed proposals under TTA are ported since (the dock recipe's,
    tests/test_torch_dock_slice.py; the test keeps its name): given boxes in
    the canonical frame replace the RPN and the canonical pass, and every
    variant rescales and mirrors them, as in unit_tpu."""
    tcfg, jmodel, params, tmodel = pair
    batch = tta_inputs(tcfg, "two scales x flip")
    rng = np.random.RandomState(5)
    h, w = batch["image_size"][0]
    xy = rng.uniform(0, [w - 30, h - 30], (1, 24, 2))
    pb = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, (1, 24, 2)), [w, h])],
                        -1).astype(np.float32)
    pv = np.ones((1, 24), bool)
    pv[0, -2:] = False
    flips = [v["flip"] for v in batch["variants"]]

    @jax.jit
    def tta_fn(params, image, image_size, var_arrays, boxes, valid):
        variants = [{"image": im, "image_size": sz, "scale": sc, "flip": fl}
                    for (im, sz, sc), fl in zip(var_arrays, flips)]
        return jmodel.apply({"params": params}, image, image_size, variants,
                            proposal_boxes=boxes, proposal_valid=valid,
                            method=JWSRCNN.predict_tta)

    var_arrays = [(jnp.asarray(v["image"]), jnp.asarray(v["image_size"]), np.float32(v["scale"]))
                  for v in batch["variants"]]
    dj = tta_fn(params, jnp.asarray(batch["image"]), jnp.asarray(batch["image_size"]),
                var_arrays, jnp.asarray(pb), jnp.asarray(pv))
    tvars = [{"image": torch.as_tensor(v["image"]), "image_size": torch.as_tensor(v["image_size"]),
              "scale": v["scale"], "flip": v["flip"]} for v in batch["variants"]]
    with torch.inference_mode():
        dt = tmodel.predict_tta(torch.as_tensor(batch["image"]),
                                torch.as_tensor(batch["image_size"]), tvars,
                                proposal_boxes=torch.as_tensor(pb),
                                proposal_valid=torch.as_tensor(pv))
    assert_same_detections(dj, dt)


def test_weak_rcnn_under_tta_scores_with_predict_tta_as_unit_tpu_does(pair, monkeypatch):
    """ROADMAP R9: without TTA a WeakRCNN model predicts with the weak
    detector alone (predict_weak_only), but unit_tpu's tta_fn calls
    predict_tta for every model (unit_tpu/engine/runner.py:369-394), which
    adds the supervised head and the transfer.  The port keeps this for
    parity; this test pins it."""
    import dataclasses

    from unit_tpu_torch.engine.predict import make_predict_fn, make_tta_predict_fn

    tcfg, _, _, tmodel = pair
    calls = []
    monkeypatch.setattr(tmodel, "mc", dataclasses.replace(tmodel.mc,
                                                          meta_architecture="WeakRCNN"))
    for name in ("predict_tta", "predict_weak_only"):
        monkeypatch.setattr(tmodel, name, lambda *a, _n=name, **k: calls.append(_n))
    batch = tta_inputs(tcfg, "identity")
    make_tta_predict_fn(tmodel)(batch)
    make_predict_fn(tmodel)(batch["image"], batch["image_size"])
    assert calls == ["predict_tta", "predict_weak_only"]


# ----------------------------------------------------------------- the runner
@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"), n_images=4)


def test_eval_only_with_tta_matches_unit_tpus_eval_fn(pair, devkit, tmp_path, monkeypatch):
    tcfg, jmodel, params, tmodel = pair
    opts = ["MODEL.WEIGHTS", "", *SMALL, "TEST.AUG.ENABLED", "True",
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "DATASETS.CLASSIFIER_DATAROOT", devkit,
            "MODEL.ROI_HEADS.EMBEDDING_PATH", ""]  # keep the shared embeddings
    jcfg, _ = both_cfgs(FLAGSHIP, *opts)
    jdata.DatasetCatalog.clear()
    jdata.RegisterVOC(jcfg, devkit).register_all()
    fed = {"jax": {}, "torch": {}}

    def recording(cls, key):
        real = cls.process

        def process(self, image_id, boxes, scores, classes, valid, **kw):
            fed[key][image_id] = tuple(np.asarray(a) for a in (boxes, scores, classes, valid))
            return real(self, image_id, boxes, scores, classes, valid, **kw)
        monkeypatch.setattr(cls, "process", process)

    recording(JPascalVOCEvaluator, "jax")
    recording(PascalVOCEvaluator, "torch")
    want = jrunner.make_eval_fn(jcfg, jmodel, image_loader=seeded_image_loader)(params)

    # the same weights as one of the port's checkpoints, read as MODEL.WEIGHTS
    weights = Checkpointer(str(tmp_path / "init")).save(
        0, TrainState(tmodel, build_optimizer(tcfg, tmodel), 0))
    args = runner.default_argument_parser().parse_args([
        "--config-file", FLAGSHIP, "--device", "cpu", "--data-root", devkit, "--eval-only",
        *opts, "MODEL.WEIGHTS", weights, "OUTPUT_DIR", str(tmp_path / "out")])
    tdata.DatasetCatalog.clear()
    got = runner.run(args, image_loader=seeded_image_loader)
    assert got["inference_seconds_per_image"] > 0
    # the detections each evaluator was fed, in original-image coordinates
    assert sorted(fed["torch"]) == sorted(fed["jax"]) and len(fed["jax"]) == 4
    for image_id, (boxes, scores, classes, valid) in fed["jax"].items():
        tb, ts, tc, tv = fed["torch"][image_id]
        assert tv.sum() == valid.sum() > 0
        # the order of two detections whose scores tie within float noise may
        # differ: sorted scores agree, and each detection has its counterpart
        # (but at the cut of the top 100, where such a tie decides which one stays)
        np.testing.assert_allclose(np.sort(ts[tv]), np.sort(scores[valid]), rtol=SCORE_RTOL)
        cut = scores[valid].min() * (1 + SCORE_RTOL)
        for b, sc, c in zip(boxes[valid], scores[valid], classes[valid]):
            match = ((tc[tv] == c) & (np.abs(ts[tv] - sc) <= SCORE_RTOL * sc)
                     & (np.abs(tb[tv] - b).max(-1) <= BOX_TOL))
            assert match.any() or sc <= cut, (image_id, b, sc, c)
    assert np.isfinite(want["bbox"]["AP50"])
    flat = {**want["bbox"], **want["bbox"]["class_AP50"]}
    del flat["class_AP50"]
    for k, v in flat.items():
        got_v = got["bbox"][k] if k in got["bbox"] else got["bbox"]["class_AP50"][k]
        np.testing.assert_allclose(got_v, v, atol=1e-9, err_msg=k)


def test_meta_model_under_tta_computes_no_prototypes(devkit, monkeypatch):
    _, cfg = both_cfgs(META, *SMALL, "DATASETS.CLASSIFIER_DATAROOT", devkit,
                       "INPUT.META_MIN_SIZE", "64", "DATASETS.BASE_META_SHOTS", "2")
    tdata.DatasetCatalog.clear()
    tdata.RegisterVOC(cfg, devkit).register_all()
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0))
    assert model.mc.use_meta
    calls = []
    real = runner.meta_attention
    monkeypatch.setattr(runner, "meta_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    for tta in (True, False):
        cfg.TEST.AUG.ENABLED = tta
        results = runner.make_eval_fn(cfg, model, image_loader=seeded_image_loader)(model)
        assert np.isfinite(results["bbox"]["AP50"])
        assert len(calls) == (0 if tta else 1)


def test_tta_with_precomputed_proposals_raises_in_the_eval_fn(pair):
    """Ported since (the test keeps its name): the eval fn builds under TTA
    with proposal files, and its TTA predict passes a batch's proposals on
    to predict_tta."""
    from unit_tpu_torch.engine.predict import make_tta_predict_fn

    tcfg, cfg = both_cfgs(FLAGSHIP, *SMALL, "TEST.AUG.ENABLED", "True",
                          "MODEL.LOAD_PROPOSALS", "True",
                          "DATASETS.PROPOSAL_FILES_TEST", "('p.pkl',)")
    assert callable(runner.make_eval_fn(cfg, pair[3]))
    tmodel = pair[3]
    batch = tta_inputs(pair[0], "two scales x flip")
    boxes = np.asarray([[[5.0, 8.0, 60.0, 70.0], [20.0, 10.0, 110.0, 80.0],
                         [0.0, 0.0, 0.0, 0.0]]], np.float32)
    batch["proposals"], batch["proposals_valid"] = boxes, np.asarray([[True, True, False]])
    got = make_tta_predict_fn(tmodel)(batch)
    tvars = [{"image": torch.as_tensor(v["image"]), "image_size": torch.as_tensor(v["image_size"]),
              "scale": v["scale"], "flip": v["flip"]} for v in batch["variants"]]
    with torch.inference_mode():
        want = tmodel.predict_tta(torch.as_tensor(batch["image"]),
                                  torch.as_tensor(batch["image_size"]), tvars,
                                  proposal_boxes=torch.as_tensor(boxes),
                                  proposal_valid=torch.as_tensor(batch["proposals_valid"]))
    for f in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
