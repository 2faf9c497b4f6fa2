"""Predictors, similarity, transfer and Fast R-CNN inference: port vs unit_tpu.

Head math is f32 on both sides over at most a few hundred terms: atol 1e-5.
fast_rcnn_inference_single is fed IDENTICAL probs and deltas, which isolates
its NMS from upstream float noise, so classes, scores and valid slots must
agree exactly (boxes to 1e-4: exp() may differ by an ulp between libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unit_tpu.models import fast_rcnn as jfrcnn
from unit_tpu.models import predictors as jpred
from unit_tpu.models import similarity as jsim
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.models import fast_rcnn as tfrcnn
from unit_tpu_torch.models import predictors as tpred
from unit_tpu_torch.models import similarity as tsim

ATOL = 1e-5
NOVEL = (2, 5, 9, 13, 17)
BASE = tuple(i for i in range(20) if i not in NOVEL)
D = 48


def t(x):
    return torch.as_tensor(np.asarray(x))


def random_tree(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.1).astype(np.float32), params)


@pytest.mark.parametrize("oicr_iter", [3, 1])
def test_weak_detector_evaluation(oicr_iter):
    x = np.random.RandomState(oicr_iter).randn(11, D).astype(np.float32)
    jm = jpred.WeakDetectorPredictor(num_classes=20, oicr_iter=oicr_iter, detector_temp=2.0)
    params = random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want_cls, want_bbox = jm.apply({"params": params}, jnp.asarray(x),
                                   method=jpred.WeakDetectorPredictor.evaluation)
    tm = load_jax_params(tpred.WeakDetectorPredictor(D, 20, oicr_iter), params)
    with torch.no_grad():
        got_cls, got_bbox = tm.evaluation(t(x))
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=ATOL)
    np.testing.assert_allclose(got_bbox.numpy(), np.asarray(want_bbox), atol=ATOL)


def test_supervised_predictor():
    x = np.random.RandomState(2).randn(9, D).astype(np.float32)
    jm = jpred.SupervisedPredictor(num_classes=20)
    params = random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_jax_params(tpred.SupervisedPredictor(D, 20), params)
    with torch.no_grad():
        got = tm(t(x))
    for k in ("delta_scores", "proposal_deltas"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


def test_seeded_init_follows_flax_initialisers():
    g = torch.Generator().manual_seed(0)
    sup = tpred.SupervisedPredictor(2048, 20, generator=g)
    weak = tpred.WeakDetectorPredictor(2048, 20, generator=g)
    assert not sup.cls_score_delta.weight.any()  # zero-init delta scores
    assert abs(float(sup.bbox_pred_delta.weight.detach().std()) - 0.001) < 1e-4
    assert abs(float(weak.oicr_predictor_2.weight.detach().std()) - 0.01) < 1e-3
    assert not any(m.bias.any() for m in (sup.bbox_pred_delta, weak.classifier_stream))


TERMS = [
    (("cls", ("lingual",)), ("bbox", ("lingual",))),
    (("cls", ("lingual", "visual")), ("bbox", ("lingual", "visual"))),
    (("cls", ("TopK-3",)), ("bbox", ("WTopK-4",))),
    (("cls", ("LSDA-3", "lingual")), ("bbox", ("VisualK-3",))),
    (("cls", ("visual", "VisualK-2")), ("bbox", ("Average",))),
    (("cls", ("None",)), ("bbox", ("lingual", "visual")), ("seg", ())),
]


def sim_inputs(seed=4, n=13):
    rng = np.random.RandomState(seed)
    return (rng.randn(80, 300).astype(np.float32) * 0.3,
            rng.randn(3, n, 21).astype(np.float32) * 2.0,
            rng.randn(21, D).astype(np.float32))


# the product combination reads lingual and visual terms only
@pytest.mark.parametrize("terms,combination", [(x, "Sum") for x in TERMS] + [
    (TERMS[0], "Product"), (TERMS[1], "Product"), (TERMS[5], "Product")])
def test_similarity_matrices(terms, combination):
    emb, weak, wmean = sim_inputs()
    kw = dict(terms=terms, base_ids=BASE, novel_ids=NOVEL,
              coco_indexer=tuple(int(i) for i in jsim.coco_indexer_for(jsim.VOC_CLASSES)),
              combination=combination)
    want = jsim.similarity_matrices(jsim.SimilarityConfig(**kw), jnp.asarray(emb),
                                    jnp.asarray(weak), jnp.asarray(wmean))
    got = tsim.similarity_matrices(tsim.SimilarityConfig(**kw), t(emb), t(weak), t(wmean))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


def test_coco_indexer_and_class_lists():
    assert tsim.VOC_CLASSES == jsim.VOC_CLASSES and tsim.COCO_CLASSES == jsim.COCO_CLASSES
    np.testing.assert_array_equal(tsim.coco_indexer_for(tsim.VOC_CLASSES),
                                  jsim.coco_indexer_for(jsim.VOC_CLASSES))


@pytest.mark.parametrize("per_roi", [False, True])
def test_transfer(per_roi):
    rng = np.random.RandomState(6)
    n = 17
    scores = rng.randn(n, 21).astype(np.float32)
    deltas = rng.randn(n, 80).astype(np.float32)
    shape = (n, 5, 15) if per_roi else (5, 15)
    sim = rng.rand(*shape).astype(np.float32)
    want = jpred.transfer_scores(jnp.asarray(scores), jnp.asarray(sim), np.asarray(BASE),
                                 np.asarray(NOVEL))
    got = tpred.transfer_scores(t(scores), t(sim), BASE, NOVEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want = jpred.transfer_deltas(jnp.asarray(deltas), jnp.asarray(sim), np.asarray(BASE),
                                 np.asarray(NOVEL), 20)
    got = tpred.transfer_deltas(t(deltas), t(sim), BASE, NOVEL, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_combine_cls_logits():
    rng = np.random.RandomState(7)
    delta = rng.randn(9, 21).astype(np.float32)
    weak = rng.randn(3, 9, 21).astype(np.float32)
    want = jpred.combine_cls_logits(jnp.asarray(delta), jnp.asarray(weak))
    got = tpred.combine_cls_logits(t(delta), t(weak))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("p,thresh", [(200, 0.05), (40, 0.2), (3, 0.05)])
def test_fast_rcnn_inference_single(p, thresh):
    rng = np.random.RandomState(p)
    c = 20
    logits = rng.randn(p, c + 1).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = (rng.randn(p, c * 4) * 0.2).astype(np.float32)
    xy = rng.uniform(0, 300, (p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 200, (p, 2))], 1).astype(np.float32)
    valid = rng.rand(p) > 0.1
    hw = (317.0, 405.0)
    cfg_kw = dict(num_classes=c, score_thresh=thresh)
    want = jfrcnn.fast_rcnn_inference_single(
        jnp.asarray(probs.astype(np.float32)), jnp.asarray(deltas), jnp.asarray(boxes),
        jnp.asarray(valid), hw, jfrcnn.FastRCNNConfig(**cfg_kw))
    got = tfrcnn.fast_rcnn_inference_single(
        t(probs.astype(np.float32)), t(deltas), t(boxes), t(valid), hw,
        tfrcnn.FastRCNNConfig(**cfg_kw))
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got.classes.numpy()[ok], np.asarray(want.classes)[ok])
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy()[ok], np.asarray(want.boxes)[ok], atol=1e-4)
