"""The dock recipe end to end: unit_tpu_torch vs unit_tpu on shared weights.

configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml (VGG-CNN-F, ROIPool at 6x6, the
VGG fc head at 4096, 80 classes, as unit_tpu's WSRCNN builds them) on a
160x224 canvas (a 9x13 map), in f32, with precomputed proposals: one train
step's losses and every gradient leaf with strong and weak proposals (no RPN
loss), the same with the YAML alone (the strong stream on the RPN, the weak
one on R12's all-invalid slots), predict_raw and predict with proposals,
predict_tta with proposals over two scales and their flips; the strict
weight conversion; and the dropout generator of the train step.  The
modules alone are tests/test_torch_dock.py, the run loop
tests/test_torch_dock_run.py.

The train step samples in the keep-everything regime of
tests/test_torch_losses.py (8 proposals + 4 GT slots = BATCH_SIZE_PER_IMAGE
12, positive fraction 1): no random choice, so both packages sample the
same ROIs.  No dropout generator on either side: dropout's masks cannot
match (threefry against Philox).

Weights: tests/test_full_graph_torch_parity.py's randomize_params; for
predict with the class-score kernels (``cls_score_delta``, the OICR
predictors) 1000x larger, so that the 81 class probabilities spread (0.3 to
0.8 at the top; under randomize_params they all sit near 1/81, below the
score threshold, and larger weights everywhere decode boxes to nothing).
Bounds:
losses rtol 1e-4, every gradient within 1e-3 * max|g_jax| + 1e-6,
probabilities within 1e-5 and deltas within 1e-4 (f32 through a 5-conv
backbone and two fc layers), final boxes within 0.05 px, scores within 1e-5
and classes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_coco_slice import coco_batches
from tests.test_torch_note import param_shapes
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_leaves
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine.train import TrainerNoMeta, dropout_seed, step_seed
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

DOCK = "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"
H, W = 160, 224
LOSS_RTOL, GRAD_REL, GRAD_ATOL = 1e-4, 1e-3, 1e-6
PROB_TOL, BBOX_TOL, BOX_TOL = 1e-5, 1e-4, 0.05
SMALL = [
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "300", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "300", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",          # > 1755 anchors
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "12",      # = 8 proposals + 4 GT slots
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.02",
]


def t(x):
    return torch.as_tensor(np.asarray(x))


def dock_cfgs(*opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(DOCK)
        cfg.merge_from_list(SMALL + list(opts))
    return jcfg, tcfg


def proposals(rng, gt_boxes, n, h=H, w=W):
    """[B, n, 4] boxes: jittered GT boxes first, then random ones, some
    thinner than a map cell (ROIPool's ties); valid [B, n] with the last
    slot of the first image invalid."""
    b = gt_boxes.shape[0]
    boxes = np.zeros((b, n, 4), np.float32)
    xy = rng.uniform(0, [w - 20, h - 20], (b, n, 2))
    boxes[..., :2] = xy
    boxes[..., 2:] = xy + rng.uniform(4, 90, (b, n, 2))
    boxes[:, :3] = gt_boxes[:, :3] + rng.uniform(-3, 3, (b, 3, 4))
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, h)
    valid = np.ones((b, n), bool)
    valid[0, -1] = False
    return boxes, valid


def jax_step(jm, params, strong, weak):
    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return ({k: float(v) for k, v in losses.items()},
            flatten_tree(jax.tree.map(np.asarray, grads)))


def torch_step(tm, strong, weak):
    tm.zero_grad(set_to_none=True)
    losses = tm.train_losses(torch.Generator().manual_seed(0),
                             {k: t(v) for k, v in strong.items()},
                             {k: t(v) for k, v in weak.items()})
    torch.stack(list(losses.values())).sum().backward()
    return {k: float(v.detach()) for k, v in losses.items()}, flax_leaves(tm, grads=True)


@pytest.fixture(scope="module")
def dock():
    """unit_tpu's and the port's dock model on one seeded flax tree (shapes
    from jax.eval_shape), with each side's losses and gradients of a train
    step with proposals and of one from the YAML alone, and the batches."""
    jcfg, tcfg = dock_cfgs()
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    shapes = param_shapes(jm, np.zeros((1, H, W, 3), np.float32),
                          np.asarray([[H, W]], np.float32))
    params = randomize_params(shapes, seed=3)
    strong, weak = coco_batches(tcfg)
    del strong["gt_masks"]
    rng = np.random.RandomState(14)
    strong["proposals"], strong["proposals_valid"] = proposals(rng, strong["gt_boxes"], 8)
    weak["proposals"], weak["proposals_valid"] = proposals(rng, strong["gt_boxes"], 16)
    tm = WSRCNN(ModelConfig.from_cfg(tcfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(tcfg, tm)  # the recipe's freezes, as the trainer applies them
    out = dict(jm=jm, tm=tm, params=params, jcfg=jcfg, tcfg=tcfg, strong=strong, weak=weak)
    out["with_files"] = jax_step(jm, params, strong, weak), torch_step(tm, strong, weak)
    # the YAML alone: no strong proposals (the RPN), the weak slots all invalid (R12)
    strong_rpn = {k: v for k, v in strong.items() if not k.startswith("proposals")}
    weak_r12 = dict(weak, proposals=np.zeros_like(weak["proposals"]),
                    proposals_valid=np.zeros_like(weak["proposals_valid"]))
    out["yaml_alone"] = (jax_step(jm, params, strong_rpn, weak_r12),
                         torch_step(tm, strong_rpn, weak_r12))
    spread = jax.tree.map(np.asarray, params)
    for head in ("cls_score_delta", "oicr_predictor_0", "oicr_predictor_1", "oicr_predictor_2"):
        part = spread["supervised" if head.startswith("cls") else "weak_detector"][head]
        part["kernel"] = part["kernel"] * 1000.0
    out["params_pred"] = spread
    out["tm_pred"] = load_jax_params(WSRCNN(ModelConfig.from_cfg(tcfg)), spread).eval()
    return out


@pytest.mark.parametrize("case", ["with_files", "yaml_alone"])
def test_train_losses_match(dock, case):
    (want, _), (got, _) = dock[case]
    assert set(got) == set(want) and {"loss_cls", "loss_box_reg", "loss_im_cls",
                                      "loss_oicr_3"} <= set(got)
    # precomputed strong proposals take the RPN out of the step
    assert any(k.startswith("loss_rpn") for k in got) == (case == "yaml_alone")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("case", ["with_files", "yaml_alone"])
def test_train_gradients_match(dock, case):
    (_, grads_j), (_, grads_t) = dock[case]
    trained = {k for k, v in grads_t.items() if v is not None}
    want_trained = {k for k, v in grads_j.items() if np.abs(v).max() > 0} - {"embeddings"}
    assert want_trained <= trained
    assert {"backbone/conv1/kernel", "box_head/fc/fc6/kernel",
            "box_head/fc/fc7/bias"} <= want_trained
    # with proposals for both streams the RPN gets no gradient in either package
    assert ("rpn_head/conv/kernel" in want_trained) == (case == "yaml_alone")
    for path in trained:
        want = grads_j[path]
        g = grads_t[path]
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)


def test_weights_convert_strictly_both_ways(dock):
    tree = flatten_tree(jax.tree.map(np.asarray, dock["params"]))
    back = flax_leaves(dock["tm"])
    assert set(back) == set(tree) - {"embeddings"}
    for path in ("backbone/conv1/kernel", "box_head/fc/fc6/kernel", "box_head/fc/fc7/kernel"):
        np.testing.assert_array_equal(back[path], tree[path], err_msg=path)
    assert tree["backbone/conv1/kernel"].shape == (11, 11, 3, 64)
    assert tree["box_head/fc/fc6/kernel"].shape == (9216, 4096)


def jax_predict_raw(dock, images, sizes, pb, pv):
    jm = dock["jm"]
    return jax.tree.map(np.asarray, jax.jit(lambda p, i, s, b, v: jm.apply(
        {"params": p}, i, s, proposal_boxes=b, proposal_valid=v,
        method=JWSRCNN.predict_raw)[:3])(dock["params_pred"], jnp.asarray(images),
                                         jnp.asarray(sizes), jnp.asarray(pb), jnp.asarray(pv)))


def detections(d, i):
    return [{"box": np.asarray(d.boxes[i][k]), "score": float(d.scores[i][k]),
             "class_id": int(d.classes[i][k])} for k in np.flatnonzero(np.asarray(d.valid[i]))]


def assert_same_detections(got, want):
    assert len(got) == len(want) > 0
    for w in want:
        match = [g for g in got if g["class_id"] == w["class_id"]
                 and abs(g["score"] - w["score"]) < PROB_TOL
                 and np.abs(g["box"] - w["box"]).max() < BOX_TOL]
        assert match, f"no counterpart for {w}"


def test_predict_with_proposals_matches(dock):
    """predict_raw and predict with the strong batch's proposals: the RPN
    skipped, the proposals' own boxes and validity, then the final NMS."""
    tm, strong = dock["tm_pred"], dock["strong"]
    images, sizes = strong["image"], strong["image_size"]
    pb, pv = strong["proposals"], strong["proposals_valid"]
    probs_j, bbox_j, props_j = jax_predict_raw(dock, images, sizes, pb, pv)
    with torch.inference_mode():
        probs_t, bbox_t, props_t, feats = tm.predict_raw(t(images), t(sizes), t(pb), t(pv))
        dets_t = tm.predict(t(images), t(sizes), t(pb), t(pv))
    assert tuple(feats.shape) == (2, 9, 13, 256)
    np.testing.assert_array_equal(props_t.boxes.numpy(), pb)
    np.testing.assert_array_equal(props_t.valid.numpy(), np.asarray(props_j.valid))
    assert np.abs(probs_t.numpy() - probs_j).max() < PROB_TOL
    assert np.abs(bbox_t.numpy() - bbox_j).max() < BBOX_TOL * max(1.0, np.abs(bbox_j).max())
    jm = dock["jm"]
    dets_j = jax.tree.map(np.asarray, jax.jit(lambda p, i, s, b, v: jm.apply(
        {"params": p}, i, s, proposal_boxes=b, proposal_valid=v, method=JWSRCNN.predict))(
        dock["params_pred"], jnp.asarray(images), jnp.asarray(sizes), jnp.asarray(pb),
        jnp.asarray(pv)))
    for i in range(2):
        assert_same_detections(detections(dets_t, i), detections(dets_j, i))


def test_predict_tta_with_proposals_matches(dock):
    """Two scales and their flips scoring the canonical proposals, rescaled
    and mirrored per variant; no canonical pass.  With TPU.TTA_PROPOSAL_TOPK
    the first K valid proposals (their objectness is zero), in both."""
    tm, strong = dock["tm_pred"], dock["strong"]
    rng = np.random.RandomState(21)
    canon = strong["image"][:1]
    size = np.asarray([[H, W]], np.float32)
    pb, pv = strong["proposals"][:1], strong["proposals_valid"][:1]
    variants = []
    for scale, (h, w) in ((1.0, (H, W)), (1.2, (192, 269))):
        img = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
        for flip in (False, True):
            variants.append({"image": img[:, :, ::-1].copy() if flip else img,
                             "image_size": np.asarray([[h, w]], np.float32),
                             "scale": scale, "flip": flip})
    jm = dock["jm"]
    for topk in (0, 5):
        def jfn(p, c, s, vs, b, v):
            return jm.apply({"params": p}, c, s, [dict(var, flip=f) for var, f in
                                                  zip(vs, [x["flip"] for x in variants])],
                            proposal_boxes=b, proposal_valid=v, tta_topk=topk,
                            method=JWSRCNN.predict_tta)

        jvars = [{"image": jnp.asarray(v["image"]), "image_size": jnp.asarray(v["image_size"]),
                  "scale": jnp.float32(v["scale"])} for v in variants]
        want = jax.tree.map(np.asarray, jax.jit(jfn)(dock["params_pred"], jnp.asarray(canon),
                                                     jnp.asarray(size), jvars,
                                                     jnp.asarray(pb), jnp.asarray(pv)))
        with torch.inference_mode():
            got = tm.predict_tta(t(canon), t(size), [dict(v, image=t(v["image"]),
                                                          image_size=t(v["image_size"]))
                                                     for v in variants],
                                 proposal_boxes=t(pb), proposal_valid=t(pv), tta_topk=topk)
        assert_same_detections(detections(got, 0), detections(want, 0))


def test_dropout_draws_from_its_own_generator(dock):
    """The train step's dropout generator: the same seed gives the same
    losses, dropout changes them, and the sampling generator is left as it
    would be without dropout (no other draw of the step moves)."""
    tm, strong, weak = dock["tm"], dock["strong"], dock["weak"]
    s = {k: t(v) for k, v in strong.items()}
    w = {k: t(v) for k, v in weak.items()}

    def losses(drop_seed):
        g = torch.Generator().manual_seed(5)
        d = None if drop_seed is None else torch.Generator().manual_seed(drop_seed)
        with torch.no_grad():
            out = tm.train_losses(g, s, w, dropout_generator=d)
        return {k: float(v) for k, v in out.items()}, g.get_state()

    (plain, g0), (a, g1), (b, g2) = losses(None), losses(dropout_seed(9)), losses(dropout_seed(9))
    assert a == b and a != plain
    assert torch.equal(g0, g1) and torch.equal(g1, g2)
    assert dropout_seed(step_seed(0, 3)) != step_seed(0, 3)
    # the trainer hands a dropout generator to VGG heads alone
    trainer = TrainerNoMeta(tm, build_optimizer(dock["tcfg"], tm), iter([]), iter([]))
    assert trainer.dropout
    trainer.init_state()
    gen, drop = trainer._generator(0), trainer._generator(0, dropout=True)
    assert gen.initial_seed() == step_seed(0, 0) and drop.initial_seed() == dropout_seed(
        step_seed(0, 0))
