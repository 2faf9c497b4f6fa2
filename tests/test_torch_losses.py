"""Matching, sampling and the training losses: unit_tpu_torch vs unit_tpu.

Every comparison feeds the same seeded numpy inputs to both packages.

Bounds, each with its reason:
  * matcher and sampling decisions are exact (integer labels and indices of
    the same f32 comparisons);
  * loss values: rtol 1e-5, the bound tests/test_train_loss_torch_parity.py
    meets between independent f32 stacks (measured agreement ~1e-7);
  * train_losses of the small flagship (depth 26, RES2_OUT_CHANNELS 64,
    160x224 canvas, f32, PRE/POST_NMS_TOPK_TRAIN 600/64): every loss term to
    rtol 1e-4 (an R-26 forward in two libraries: ~1e-6 relative noise in the
    features, measured 1e-7 in the losses), and after one backward pass
    every trainable leaf's gradient within 2e-3 * max|g_jax| + 1e-6 of
    jax.grad's (the same noise through the backward: measured ~5e-7 of each
    leaf's scale; the 1e-6 floor covers leaves whose gradient vanishes by
    symmetry, e.g. the detection stream's bias, where only rounding noise of
    ~1e-9 remains).

The two packages cannot share an RNG, so sampling is compared where it keeps
every candidate (RPN.BATCH_SIZE_PER_IMAGE above the anchor count, ROI batch
above the candidate count, positive fraction 1: the recipe of
tests/test_train_loss_torch_parity.py:25-32) and by its properties elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from unit_tpu.config import get_cfg
from unit_tpu.models import fast_rcnn as jfrcnn
from unit_tpu.models import rpn as jrpn
from unit_tpu.models import weak_losses as jweak
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.ops import matcher as jmatcher
from unit_tpu.ops import sampling as jsampling
from unit_tpu.structures.instances import GTInstances as JGT
from unit_tpu.structures.instances import SampledProposals as JSampled
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import fast_rcnn as tfrcnn
from unit_tpu_torch.models import rpn as trpn
from unit_tpu_torch.models import weak_losses as tweak
from unit_tpu_torch.ops import matcher as tmatcher
from unit_tpu_torch.ops import sampling as tsampling
from unit_tpu_torch.solver import build_optimizer
from unit_tpu_torch.structures.instances import GTInstances, SampledProposals

RTOL = 1e-5
TRAIN_RTOL = 1e-4
GRAD_REL, GRAD_ATOL = 2e-3, 1e-6
C = 20
BASE = (0, 1, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19)
NOVEL = (2, 5, 9, 13, 17)


def t(x):
    return torch.as_tensor(np.array(x))


def boxes(rng, n, h=160.0, w=224.0, lo=8.0, hi=120.0):
    xy = rng.uniform(0, 1, (n, 2)) * [w - lo, h - lo]
    wh = rng.uniform(lo, hi, (n, 2))
    b = np.concatenate([xy, xy + wh], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return b.astype(np.float32)


def gt_batch(rng, b=2, g=5, n_valid=(3, 1)):
    gt_boxes = np.stack([boxes(rng, g) for _ in range(b)])
    classes = rng.choice(BASE, (b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    return gt_boxes, classes, valid


# --------------------------------------------------------------------- matcher
@pytest.mark.parametrize("case", ["random", "no_gt", "ties"])
@pytest.mark.parametrize("low_quality", [False, True])
def test_match(case, low_quality):
    rng = np.random.RandomState(3)
    q = rng.rand(6, 50).astype(np.float32)
    valid = np.asarray([True, False, True, True, False, True])
    if case == "no_gt":
        valid[:] = False
    if case == "ties":
        q = np.round(q * 4) / 4  # many exact ties, incl. per-gt best ties
    thr, lab = (0.3, 0.7), (0, -1, 1)
    want = jmatcher.match(jnp.asarray(q), jnp.asarray(valid), thr, lab, low_quality)
    got = tmatcher.match(t(q), t(valid), thr, lab, low_quality)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -------------------------------------------------------------------- sampling
def test_label_and_sample_keeps_everything_like_unit_tpu():
    """Sampling that keeps every candidate: the slots are identical."""
    rng = np.random.RandomState(4)
    props = boxes(rng, 40)
    props[5:9] = props[30:34] * 0.98  # near duplicates of one another
    pvalid = rng.rand(40) > 0.15
    gtb, gtc, gtv = gt_batch(rng)
    for i in range(2):
        args = (props, pvalid)
        want = jsampling.label_and_sample_proposals(
            jax.random.PRNGKey(i), *(jnp.asarray(a) for a in args),
            JGT(boxes=jnp.asarray(gtb[i]), classes=jnp.asarray(gtc[i]),
                valid=jnp.asarray(gtv[i])), 64, 1.0, C)
        got = tsampling.label_and_sample_proposals(
            torch.Generator().manual_seed(i), *(t(a) for a in args),
            GTInstances(t(gtb[i]), t(gtc[i]), t(gtv[i])), 64, 1.0, C)
        for f in ("boxes", "gt_classes", "gt_boxes", "valid", "is_fg", "gt_index"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert int(got.is_fg.sum()) >= int(gtv[i].sum())  # appended GT are foreground


def test_label_and_sample_properties():
    """Real sampling: min(available, cap) of each kind, fg slots first, the
    same generator seed gives the same selection, another seed another."""
    rng = np.random.RandomState(5)
    props = np.concatenate([boxes(rng, 150), boxes(rng, 50, lo=40, hi=60)])
    gtb, gtc, gtv = gt_batch(rng, n_valid=(4, 2))
    gt = GTInstances(t(gtb[0]), t(gtc[0]), t(gtv[0]))
    pvalid = torch.ones(200, dtype=torch.bool)
    out = [tsampling.label_and_sample_proposals(torch.Generator().manual_seed(s), t(props),
                                                pvalid, gt, 64, 0.25, C)
           for s in (7, 7, 8)]
    full = tsampling.label_and_sample_proposals(None, t(props), pvalid, gt, 10**6, 1.0, C)
    n_fg_avail, n_bg_avail = int(full.is_fg.sum()), int((full.valid & ~full.is_fg).sum())
    a = out[0]
    n_fg = int(a.is_fg.sum())
    assert n_fg == min(n_fg_avail, 16)
    assert int(a.valid.sum()) == n_fg + min(n_bg_avail, 64 - n_fg)
    assert a.boxes.shape == (64, 4)
    assert bool(a.is_fg[:n_fg].all()) and not bool(a.is_fg[n_fg:].any())
    assert bool((a.gt_classes[:n_fg] < C).all()) and bool((a.gt_classes[n_fg:] == C).all())
    assert torch.equal(a.boxes, out[1].boxes) and not torch.equal(a.boxes, out[2].boxes)


def test_subsample_label_masks_counts():
    g = torch.Generator().manual_seed(0)
    is_pos = torch.zeros(300, dtype=torch.bool)
    is_pos[:40] = True
    is_neg = ~is_pos
    is_neg[250:] = False  # ignored
    pos, neg = tsampling.subsample_label_masks(g, is_pos, is_neg, 64, 0.25)
    assert int(pos.sum()) == 16 and int(neg.sum()) == 48
    assert not bool((pos & ~is_pos).any()) and not bool((neg & ~is_neg).any())
    pos, neg = tsampling.subsample_label_masks(g, is_pos, is_neg, 1000, 0.5)
    assert int(pos.sum()) == 40 and int(neg.sum()) == 210


# ---------------------------------------------------------------------- losses
def test_rpn_losses():
    """Every anchor kept (batch size per image above the anchor count)."""
    rng = np.random.RandomState(6)
    cfg_kw = dict(batch_size_per_image=1024, positive_fraction=0.5)
    anchors = np.asarray(jrpn.get_anchors(6, 8, jrpn.RPNConfig()))
    assert anchors.shape[0] < 1024
    gtb, gtc, gtv = gt_batch(rng, g=4, n_valid=(3, 2))
    logits = rng.randn(2, anchors.shape[0]).astype(np.float32) * 2
    deltas = rng.randn(2, anchors.shape[0], 4).astype(np.float32) * 0.3
    want = jrpn.rpn_losses(jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(deltas),
                           jnp.asarray(anchors), JGT(boxes=jnp.asarray(gtb),
                                                     classes=jnp.asarray(gtc),
                                                     valid=jnp.asarray(gtv)),
                           jrpn.RPNConfig(**cfg_kw))
    got = trpn.rpn_losses(torch.Generator().manual_seed(0), t(logits), t(deltas), t(anchors),
                          GTInstances(t(gtb), t(gtc).long(), t(gtv)),
                          trpn.RPNConfig(**cfg_kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
    assert float(got["loss_rpn_loc"]) > 0


@pytest.mark.parametrize("training", [True, False])
def test_select_proposals(training):
    """Training (pre/post top-k 600/64 here, 12000/2000 in the recipe) and
    test selection: the same proposals, slots and validity as unit_tpu."""
    rng = np.random.RandomState(11)
    cfg_kw = dict(pre_nms_topk_train=600, post_nms_topk_train=64, pre_nms_topk_test=300,
                  post_nms_topk_test=32)
    anchors = np.asarray(jrpn.get_anchors(10, 14, jrpn.RPNConfig()))
    logits = rng.randn(2, anchors.shape[0]).astype(np.float32)
    deltas = (rng.randn(2, anchors.shape[0], 4) * 0.2).astype(np.float32)
    sizes = np.asarray([[160, 224], [150, 200]], np.float32)
    want = jrpn.select_proposals(jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors),
                                 jnp.asarray(sizes), jrpn.RPNConfig(**cfg_kw), training=training)
    got = trpn.select_proposals(t(logits), t(deltas), t(anchors), t(sizes),
                                trpn.RPNConfig(**cfg_kw), training=training)
    assert got.boxes.shape[1] == (64 if training else 32)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4)
    np.testing.assert_array_equal(got.objectness.numpy(), np.asarray(want.objectness))


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_smooth_l1(beta):
    rng = np.random.RandomState(7)
    a, b = rng.randn(2, 30).astype(np.float32)
    np.testing.assert_allclose(trpn.smooth_l1(t(a), t(b), beta).numpy(),
                               np.asarray(jrpn.smooth_l1(jnp.asarray(a), jnp.asarray(b), beta)),
                               rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_fast_rcnn_losses(beta):
    rng = np.random.RandomState(8)
    n = 60
    fields = dict(
        boxes=boxes(rng, n), gt_boxes=boxes(rng, n),
        gt_classes=rng.randint(0, C + 1, n).astype(np.int32),
        valid=rng.rand(n) > 0.2)
    fields["is_fg"] = (fields["gt_classes"] < C) & fields["valid"]
    fields["gt_index"] = np.zeros(n, np.int32)
    scores = rng.randn(n, C + 1).astype(np.float32) * 3
    deltas = rng.randn(n, C * 4).astype(np.float32)
    scores_j = jfrcnn.mask_novel_scores(jnp.asarray(scores), NOVEL)
    scores_t = tfrcnn.mask_novel_scores(t(scores), NOVEL)
    np.testing.assert_array_equal(scores_t.numpy(), np.asarray(scores_j))
    fields["gt_classes"][fields["gt_classes"] == NOVEL[0]] = BASE[0]  # base training
    want = jfrcnn.fast_rcnn_losses(
        scores_j, jnp.asarray(deltas), JSampled(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jfrcnn.FastRCNNConfig(num_classes=C, smooth_l1_beta=beta))
    got = tfrcnn.fast_rcnn_losses(
        scores_t, t(deltas),
        SampledProposals(**{k: t(v).long() if v.dtype == np.int32 else t(v)
                            for k, v in fields.items()}),
        tfrcnn.FastRCNNConfig(num_classes=C, smooth_l1_beta=beta))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)


def weak_inputs(seed=9, b=2, p=48):
    rng = np.random.RandomState(seed)
    props = np.stack([boxes(rng, p) for _ in range(b)])
    valid = rng.rand(b, p) > 0.1
    labels = np.zeros((b, C), np.float32)
    labels[0, [BASE[0], NOVEL[1], BASE[7]]] = 1.0
    labels[1, [NOVEL[0]]] = 1.0
    streams = {
        "classifier_stream": rng.randn(b * p, C).astype(np.float32),
        "detection_stream": rng.randn(b * p, C).astype(np.float32) * 2,
        "oicr_scores": [rng.randn(b * p, C + 1).astype(np.float32) for _ in range(3)],
    }
    return props, valid, labels, streams


def test_weak_loss_pieces():
    props, valid, labels, streams = weak_inputs()
    b, p = valid.shape
    cls = streams["classifier_stream"].reshape(b, p, C)
    det = streams["detection_stream"].reshape(b, p, C)
    cfg_kw = dict(num_classes=C)
    x_t, v_t = tweak.mil_image_scores(t(cls), t(det), t(valid))
    for i in range(b):
        x_j, v_j = jweak.mil_image_scores(jnp.asarray(cls[i]), jnp.asarray(det[i]),
                                          jnp.asarray(valid[i]))
        np.testing.assert_allclose(x_t[i].numpy(), np.asarray(x_j), rtol=RTOL, atol=1e-8)
        np.testing.assert_allclose(v_t[i].numpy(), np.asarray(v_j), rtol=RTOL, atol=1e-8)
    np.testing.assert_allclose(
        float(tweak.binary_cross_entropy(v_t, t(labels))),
        float(jweak.binary_cross_entropy(jnp.asarray(v_t.numpy()), jnp.asarray(labels))),
        rtol=RTOL)
    pseudo_t = tweak.mine_pseudo_gt(x_t, t(props), t(valid), t(labels), C)
    for i in range(b):
        pseudo_j = jweak.mine_pseudo_gt(jnp.asarray(x_t[i].numpy()), jnp.asarray(props[i]),
                                        jnp.asarray(valid[i]), jnp.asarray(labels[i]), C)
        np.testing.assert_array_equal(pseudo_t.boxes[i].numpy(), np.asarray(pseudo_j.boxes))
        np.testing.assert_array_equal(pseudo_t.scores[i].numpy(), np.asarray(pseudo_j.scores))
        np.testing.assert_array_equal(pseudo_t.valid[i].numpy(), np.asarray(pseudo_j.valid))
        one = tweak.PseudoGT(pseudo_t.boxes[i], pseudo_t.scores[i], pseudo_t.valid[i])
        got = tweak.oicr_targets(one, t(props[i]), t(valid[i]), tweak.WeakLossConfig(**cfg_kw))
        want = jweak.oicr_targets(pseudo_j, jnp.asarray(props[i]), jnp.asarray(valid[i]),
                                  jweak.WeakLossConfig(**cfg_kw))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        logits = streams["oicr_scores"][0].reshape(b, p, -1)[i]
        np.testing.assert_allclose(
            float(tweak.weighted_ce(t(logits), got[0], got[1], t(valid[i]))),
            float(jweak.weighted_ce(jnp.asarray(logits), want[0], want[1],
                                    jnp.asarray(valid[i]))), rtol=RTOL)


def test_weak_detector_losses():
    props, valid, labels, streams = weak_inputs(seed=10)
    cfg_kw = dict(num_classes=C, weak_loss_multiplier=0.5, mil_multiplier=2.0)
    want = jweak.weak_detector_losses(
        {"classifier_stream": jnp.asarray(streams["classifier_stream"]),
         "detection_stream": jnp.asarray(streams["detection_stream"]),
         "oicr_scores": [jnp.asarray(s) for s in streams["oicr_scores"]]},
        jnp.asarray(props), jnp.asarray(valid), jnp.asarray(labels),
        jweak.WeakLossConfig(**cfg_kw))
    got = tweak.weak_detector_losses(
        {"classifier_stream": t(streams["classifier_stream"]),
         "detection_stream": t(streams["detection_stream"]),
         "oicr_scores": [t(s) for s in streams["oicr_scores"]]},
        t(props), t(valid), t(labels), tweak.WeakLossConfig(**cfg_kw))
    assert set(got) == set(want) == {"loss_im_cls", "loss_oicr_1", "loss_oicr_2", "loss_oicr_3"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
    assert float(got["loss_oicr_1"]) > 0


# ---------------------------------------------------------------- train_losses
H, W = 160, 224


def small_train_cfg():
    """The flagship recipe cut to size, in the keep-everything regime."""
    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "600", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
        "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",          # > 2100 anchors
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128",     # > 64 proposals + 4 GT
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
        "TPU.COMPUTE_DTYPE", "float32",
    ])
    return cfg


def train_batches(seed=1, b=2, g=4):
    rng = np.random.RandomState(seed)
    gtb = np.zeros((b, g, 4), np.float32)
    gtb[..., 0] = rng.uniform(0, W - 90, (b, g))
    gtb[..., 1] = rng.uniform(0, H - 90, (b, g))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(30, 80, (b, g, 2))
    strong = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32),
                  gt_boxes=gtb, gt_classes=rng.choice(BASE, (b, g)).astype(np.int32),
                  gt_valid=np.asarray([[True, True, True, False]] * b),
                  image_size=np.asarray([[H, W], [H - 10, W - 24]][:b], np.float32))
    labels = np.zeros((b, C), np.float32)
    for i, present in enumerate([[BASE[0], NOVEL[0], BASE[5]], [NOVEL[3], BASE[9]]][:b]):
        labels[i, present] = 1.0
    weak = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[H, W]] * b, np.float32))
    return strong, weak


def jax_params(cfg, seed=3):
    jm = JWSRCNN(mc=JModelConfig.from_cfg(cfg))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.asarray([[H, W]], jnp.float32))
    return jm, randomize_params(v["params"], seed=seed)


@pytest.fixture(scope="module")
def train_pair():
    cfg = small_train_cfg()
    jm, params = jax_params(cfg)
    strong, weak = train_batches()

    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(cfg, tm)  # freezes the stem and res2, as the trainer does
    losses_t = tm.train_losses(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in strong.items()},
                               {k: t(v) for k, v in weak.items()})
    torch.stack(list(losses_t.values())).sum().backward()
    return ({k: float(v) for k, v in losses_j.items()},
            {k: float(v.detach()) for k, v in losses_t.items()},
            flatten_tree(jax.tree.map(np.asarray, grads_j)), flax_leaves(tm, grads=True))


def test_train_losses_match(train_pair):
    losses_j, losses_t, _, _ = train_pair
    assert set(losses_t) == set(losses_j) == {
        "loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_im_cls",
        "loss_oicr_1", "loss_oicr_2", "loss_oicr_3"}
    for k in losses_j:
        np.testing.assert_allclose(losses_t[k], losses_j[k], rtol=TRAIN_RTOL, err_msg=k)
    assert losses_t["loss_box_reg"] > 0 and losses_t["loss_oicr_1"] > 0


def test_train_gradients_match(train_pair):
    _, _, grads_j, grads_t = train_pair
    frozen = {k for k, v in grads_t.items() if v is None}
    assert frozen == {k for k in grads_t
                      if k.startswith(("backbone/stem", "backbone/res2"))}, frozen
    assert len(grads_t) - len(frozen) >= 30
    for path, g in grads_t.items():
        if g is None:
            continue
        want = grads_j[path]
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)


def test_train_losses_without_a_shared_canvas():
    """Strong and weak on different canvases: two backbone passes, the same
    loss terms (strong-only and weak-only calls give their halves)."""
    cfg = small_train_cfg()
    tm = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0))
    strong, weak = train_batches(seed=2)
    weak = dict(weak, image=weak["image"][:, :, :192])
    s = {k: t(v) for k, v in strong.items()}
    w = {k: t(v) for k, v in weak.items()}
    with torch.no_grad():
        both = tm.train_losses(torch.Generator().manual_seed(1), s, w)
        only_s = tm.train_losses(torch.Generator().manual_seed(1), s, None)
        only_w = tm.train_losses(torch.Generator().manual_seed(1), None, w)
    assert set(both) == set(only_s) | set(only_w)
    for k, v in list(only_s.items()) + list(only_w.items()):
        np.testing.assert_allclose(float(both[k]), float(v), rtol=1e-6, err_msg=k)
