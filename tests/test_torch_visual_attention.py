"""The visual attention head: unit_tpu_torch vs unit_tpu on shared weights.

``VisualAttentionHead`` in its four modes at the small flagship's width
(depth 26, RES2_OUT_CHANNELS 64: D = 512), f32: the prototypes of a support
batch with a class that has no support, the likelihood, the rank losses and
their gradients through the meta head, the similarity matrix and the
classifier.  Random flax weights go through load_jax_params; inputs are made
from a numpy seed.  And the reference's likelihood underflow at D = 2048
(tests/test_rank_loss_underflow.py): exact zeros, 0.46875 and 1.0.

Bounds: prototypes, likelihoods and losses to 1e-5 (an R-26 Res5 in two
libraries: ~1e-7 relative noise); every gradient within 1e-4 of its leaf's
largest element of unit_tpu's (the same noise through the backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.models.visual_attention import MetaAttention as JMetaAttention
from unit_tpu.models.visual_attention import VisualAttentionHead as JHead
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.models.visual_attention import MetaAttention, VisualAttentionHead

MODES = ("mean", "mahalanobis", "matrix", "locatron")
NUM_CLASSES = 20
BASE = (0, 1, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19)
RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-4
SHOTS, CANVAS = 2, 64


def t(x):
    return torch.as_tensor(np.array(x))


def support_inputs(seed=0, ch=256):
    """Backbone features of C x K shots [C, K, 4, 4, ch] (a 64-pixel canvas
    at stride 16), one GT box a shot (one the whole canvas, the loader's
    fallback) and a class without support."""
    rng = np.random.RandomState(seed)
    c, k = len(BASE), SHOTS
    feats = rng.randn(c, k, CANVAS // 16, CANVAS // 16, ch).astype(np.float32)
    xy = rng.uniform(0, CANVAS * 0.6, (c, k, 2))
    wh = rng.uniform(8, CANVAS * 0.4, (c, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[3, 1] = [0, 0, CANVAS, CANVAS]
    valid = np.ones(c, bool)
    valid[5] = False
    return feats, boxes, valid


def query_inputs(seed=1, n=12, ch=256):
    """Pooled query maps [N, 14, 14, ch], their gt classes (base classes and
    the background) and validity."""
    rng = np.random.RandomState(seed)
    pooled = rng.randn(n, 14, 14, ch).astype(np.float32)
    gt = rng.choice(BASE + (NUM_CLASSES,), n).astype(np.int32)
    gt[:2] = NUM_CLASSES
    valid = np.ones(n, bool)
    valid[-3:] = False
    return pooled, gt, valid


@pytest.fixture(scope="module", params=MODES)
def heads(request):
    """(mode, unit_tpu head, its params, the port's head on them)."""
    mode = request.param
    jh = JHead(num_classes=NUM_CLASSES, depth=26, res2_out_channels=64, mode=mode)
    feats, boxes, valid = support_inputs()
    pooled, gt, qvalid = query_inputs()
    key = jax.random.PRNGKey(0)
    v1 = jh.init(key, feats, boxes, valid, np.asarray(BASE),
                 method=JHead.support_prototypes)
    att = jh.apply(v1, feats, boxes, valid, np.asarray(BASE), method=JHead.support_prototypes)
    v2 = jh.init(key, pooled, gt, qvalid, att, np.asarray(BASE), method=JHead.rank_loss)
    params = randomize_params({**v2["params"], **v1["params"]}, seed=5)
    th = VisualAttentionHead(NUM_CLASSES, depth=26, res2_out_channels=64, mode=mode,
                             roi_align_impl="plain")
    load_jax_params(th, jax.tree.map(np.asarray, params))
    return mode, jh, params, th


def test_prototypes_match(heads):
    mode, jh, params, th = heads
    feats, boxes, valid = support_inputs()
    want = jh.apply({"params": params}, feats, boxes, valid, np.asarray(BASE),
                    method=JHead.support_prototypes)
    with torch.no_grad():
        got = th.support_prototypes(t(feats), t(boxes), t(valid), BASE)
    for f in ("mean", "cov_inv", "logdet"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert not got.mean[BASE[5]].any()  # the class without support
    assert torch.isinf(got.logdet).sum() == NUM_CLASSES - len(BASE)
    assert float(got.cov_inv[NUM_CLASSES].min()) == 1.0


def test_likelihood_matches(heads):
    """At D = 8, where the Gaussian normaliser does not underflow, over the
    base slots and the background."""
    mode, jh, _, th = heads
    rng = np.random.RandomState(2)
    mean = rng.randn(NUM_CLASSES + 1, 8).astype(np.float32) * 0.5
    cov = rng.uniform(0.5, 1.5, (NUM_CLASSES + 1, 8)).astype(np.float32)
    logdet = np.full(NUM_CLASSES + 1, -np.inf, np.float32)
    logdet[list(BASE) + [NUM_CLASSES]] = 0.0
    query = rng.randn(5, 8).astype(np.float32) * 0.5
    slots = np.asarray(BASE + (NUM_CLASSES,))
    want = JHead.likelihood(jh, JMetaAttention(jnp.asarray(mean), jnp.asarray(cov),
                                               jnp.asarray(logdet)), jnp.asarray(query), slots)
    got = th.likelihood(MetaAttention(t(mean), t(cov), t(logdet)), t(query), slots)
    assert got.shape == (5, len(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)
    assert bool(torch.isfinite(got).all())
    if mode in ("mean", "mahalanobis"):
        assert float(got.min()) > 0.0  # nothing underflows at D = 8


def test_rank_losses_and_gradients_match(heads):
    """The rank losses of the query ROIs against the prototypes of the same
    head, and the gradient of their sum, which reaches the meta head through
    both the query and the support pass."""
    mode, jh, params, th = heads
    feats, boxes, valid = support_inputs()
    pooled, gt, qvalid = query_inputs()

    def loss_fn(p):
        att = jh.apply({"params": p}, feats, boxes, valid, np.asarray(BASE),
                       method=JHead.support_prototypes)
        losses = jh.apply({"params": p}, pooled, gt, qvalid, att, np.asarray(BASE),
                          method=JHead.rank_loss)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    th.zero_grad(set_to_none=True)
    att = th.support_prototypes(t(feats), t(boxes), t(valid), BASE)
    got = th.rank_loss(t(pooled), t(gt), t(qvalid), att, BASE)
    torch.stack(list(got.values())).sum().backward()
    keys = {"loss_rank_margin", "loss_rank_reg"} | (set() if mode == "locatron"
                                                    else {"loss_rank_cls"})
    assert set(got) == set(want) == keys
    for k in keys:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    grads_j = flatten_tree(jax.tree.map(np.asarray, grads))
    grads_t = flax_leaves(th, grads=True)
    # FrozenBN statistics are flax params but the port's buffers: no gradient
    assert set(grads_t) == {k for k in grads_j if "_bn/" not in k}
    for path, g in grads_t.items():
        scale = np.abs(grads_j[path]).max()
        assert g is not None, path
        assert np.abs(g - grads_j[path]).max() <= GRAD_REL * scale + 1e-9, path
    # the support shots reach the meta head only through the classification
    # loss; locatron has none, so its head trains from the query pass alone
    assert np.abs(grads_t["meta_box_head/res5/block0/conv1/kernel"]).max() > 0


def test_matrix_modes_start_from_the_identity():
    for mode in MODES:
        head = VisualAttentionHead(NUM_CLASSES, depth=26, res2_out_channels=8, mode=mode)
        names = {n for n, _ in head.named_parameters()}
        assert ("sim_matrix.weight" in names) == (mode in ("matrix", "locatron"))
        assert ("rank_loss_classifier.weight" in names) == (mode != "locatron")
        if "sim_matrix.weight" in names:
            assert torch.equal(head.sim_matrix.weight, torch.eye(64))
            assert head.sim_matrix.bias is None
        else:
            assert not torch.any(head.rank_loss_classifier.bias)
    with pytest.raises(ValueError, match="locatron"):
        VisualAttentionHead(NUM_CLASSES, mode="cosine")


# ------------------------------------------------ the underflow, at D = 2048
def big_attention(seed, n_slots, d=2048):
    rng = np.random.RandomState(seed)
    return MetaAttention(t(rng.randn(n_slots, d).astype(np.float32)),
                         torch.ones(n_slots, d), torch.zeros(n_slots))


def test_mean_likelihood_underflows_to_exact_zero():
    head = VisualAttentionHead(15, depth=26, res2_out_channels=256, mode="mean")
    query = t(np.random.RandomState(0).randn(8, 2048).astype(np.float32))
    sim = head.likelihood(big_attention(0, 16), query, np.arange(16))
    assert sim.shape == (8, 16)
    assert not sim.any()  # exp(-1882 - maha / 2) is 0 in f32, whatever the inputs


@pytest.mark.parametrize("mode", ["mean", "mahalanobis"])
def test_rank_margin_and_reg_are_the_reference_constants(mode):
    """Similarity identically 0: the margin loss is (S - 1) 0.5 / S over the
    S = 16 slots of 15 base classes and the background, the reg loss
    max(0, 1 - 0) = 1, and neither has a gradient; the classification loss
    alone trains the meta head."""
    head = VisualAttentionHead(15, depth=26, res2_out_channels=256, mode=mode)
    rng = np.random.RandomState(1)
    pooled = t(rng.randn(4, 14, 14, 1024).astype(np.float32))
    gt = torch.tensor([0, 3, 7, 15])  # one background
    att = big_attention(2, 16)
    losses = head.rank_loss(pooled, gt, torch.ones(4, dtype=torch.bool), att, range(15))
    values = {k: v.item() for k, v in losses.items()}
    assert values["loss_rank_margin"] == np.float32(15 * 0.5 / 16) == 0.46875
    assert values["loss_rank_reg"] == 1.0
    assert values["loss_rank_cls"] > 0.0
    (losses["loss_rank_margin"] + losses["loss_rank_reg"]).backward()
    assert all(p.grad is None or not p.grad.any() for p in head.parameters())
