"""The legacy unaligned ROIAlign (POOLER_TYPE "ROIAlign") of unit_tpu_torch
against unit_tpu's, which computes it in XLA and never in its kernel
(unit_tpu/models/meta_arch.py:326-330): the port's is its plain PyTorch
ROIAlign with ``aligned=False``, forward and backward, whatever the impl.

  * the op and its gradient against unit_tpu's ``roi_align_batched(...,
    aligned=False)`` in f32 to 2e-5 (the K1 gate's bound for the same
    f32 sums), on boxes that include ones under one feature pixel (the
    legacy op widens them to one) and ones past the map;
  * the small flagship (tests/test_torch_losses.py, the keep-everything
    regime) with POOLER_TYPE ROIAlign: every loss to rtol 1e-4 and every
    trainable gradient within 1e-3 * max|g_jax| + 1e-6 of unit_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_losses import jax_params, small_train_cfg, t, train_batches
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.ops.roi_align import roi_align_batched as jroi_align_batched
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.ops.roi_align import roi_align_batched
from unit_tpu_torch.solver import build_optimizer

OP_ATOL = 2e-5
LOSS_RTOL = 1e-4
GRAD_REL, GRAD_ATOL = 1e-3, 1e-6


def op_inputs(seed=0, b=2, h=12, w=17, c=8, n=24):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, h, w, c).astype(np.float32)
    img_h, img_w = 16 * h, 16 * w
    xy = rng.uniform(-20, [img_w, img_h], (b, n, 2))
    wh = rng.uniform(30, 150, (b, n, 2))
    wh[:, : n // 4] = rng.uniform(0.5, 12, (b, n // 4, 2))  # under one feature pixel
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    g = rng.randn(b, n, 7, 7, c).astype(np.float32)
    return feats, rois, g


@pytest.mark.parametrize("p,scale", [(7, 1 / 16), (14, 1 / 16), (6, 1 / 8)])
def test_unaligned_op_and_gradient_match_unit_tpu(p, scale):
    feats, rois, _ = op_inputs()
    g = np.random.RandomState(1).randn(*rois.shape[:2], p, p, feats.shape[-1]).astype(
        np.float32)

    def jfn(f):
        return jroi_align_batched(f, jnp.asarray(rois), p, scale, 2, aligned=False, impl="xla")

    want, vjp = jax.vjp(jfn, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    tf = torch.tensor(feats, requires_grad=True)
    got = roi_align_batched(tf, t(rois), p, scale, 2, aligned=False)
    got.backward(t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_grad), atol=OP_ATOL, rtol=0)
    # the legacy op is not the aligned one: the two differ by whole percents
    aligned = roi_align_batched(t(feats), t(rois), p, scale, 2)
    assert float((aligned - got.detach()).abs().max()) > 0.05
    # without a gradient, and with impl "cuda" asked for: the plain version
    # all the same (K1 and K2 compute the aligned op only)
    with torch.no_grad():
        again = roi_align_batched(t(feats), t(rois), p, scale, 2, impl="cuda", aligned=False)
    assert torch.equal(again, got.detach())


@pytest.fixture(scope="module")
def unaligned_pair():
    cfg = small_train_cfg()
    cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlign"])
    jm, params = jax_params(cfg)
    assert jm.mc.pooler_type == "ROIAlign"
    strong, weak = train_batches()

    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = WSRCNN(ModelConfig.from_cfg(cfg))
    assert tm.mc.pooler_type == "ROIAlign"
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(cfg, tm)
    losses_t = tm.train_losses(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in strong.items()},
                               {k: t(v) for k, v in weak.items()})
    torch.stack(list(losses_t.values())).sum().backward()
    return ({k: float(v) for k, v in losses_j.items()},
            {k: float(v.detach()) for k, v in losses_t.items()},
            flatten_tree(jax.tree.map(np.asarray, grads_j)), flax_leaves(tm, grads=True))


def test_unaligned_pooler_losses_match(unaligned_pair):
    losses_j, losses_t, _, _ = unaligned_pair
    assert set(losses_t) == set(losses_j) and len(losses_j) == 8
    for k in losses_j:
        np.testing.assert_allclose(losses_t[k], losses_j[k], rtol=LOSS_RTOL, err_msg=k)


def test_unaligned_pooler_gradients_match(unaligned_pair):
    _, _, grads_j, grads_t = unaligned_pair
    trained = {k: g for k, g in grads_t.items() if g is not None}
    assert len(trained) >= 30
    for path, g in trained.items():
        want = grads_j[path]
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)
