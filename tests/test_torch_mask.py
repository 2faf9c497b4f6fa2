"""The mask head and its functions: unit_tpu_torch vs unit_tpu.

Same seeded numpy inputs through unit_tpu/models/mask_head.py and
unit_tpu_torch/models/mask_head.py; head weights shared through
load_jax_params and read back through flax_leaves.

Bounds, each with its reason:
  * head forward, in f32: 1e-5 (a 2x2 transposed convolution and a 1x1
    convolution of width 32 or less, summed in different orders, ~1e-7 of
    logits of order 1);
  * transfer, crop, loss, inference: 1e-6 (the same f32 expressions; the
    einsum sums at most 6 terms);
  * the loss's gradient against jax.grad: 1e-7 absolute (terms of order
    1 / (N * M * M) ~ 1e-3, a few f32 ulps apart);
  * the deconv weight round trip: bit-identical (a flip and a transpose).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unit_tpu.models import mask_head as jmask
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_leaves, load_jax_params
from unit_tpu_torch.models import mask_head as tmask

HEAD_TOL = 1e-5
FN_TOL = 1e-6
GRAD_ATOL = 1e-7
IN_CH, CONV_DIM, C, P = 24, 16, 6, 7
BASE_IDS, NOVEL_IDS = np.asarray([0, 2, 3, 5]), np.asarray([1, 4])


def t(x):
    return torch.as_tensor(np.array(x))


def head_pair(num_conv, finetune, in_ch=IN_CH, conv_dim=CONV_DIM, seed=0):
    """unit_tpu's head, a seeded flax tree of it, and the port's head holding it."""
    jhead = jmask.MaskRCNNConvUpsampleHead(num_classes=C, num_conv=num_conv, conv_dim=conv_dim)
    params = jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, P, P, in_ch)),
                        return_delta=finetune)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.3).astype(np.float32), params)
    thead = tmask.MaskRCNNConvUpsampleHead(in_ch, C, num_conv=num_conv, conv_dim=conv_dim,
                                           finetune=finetune)
    load_jax_params(thead, params)
    return jhead, params, thead


def features(n=3, in_ch=IN_CH, seed=1):
    return np.random.RandomState(seed).randn(n, P, P, in_ch).astype(np.float32)


@pytest.mark.parametrize("num_conv", [0, 2])
@pytest.mark.parametrize("finetune", [False, True])
def test_head_forward_matches(num_conv, finetune):
    jhead, params, thead = head_pair(num_conv, finetune)
    x = features()
    want = jhead.apply({"params": params}, jnp.asarray(x), return_delta=finetune)
    with torch.no_grad():
        logits, delta = thead(t(x))
    if finetune:
        want, want_delta = want
        np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=HEAD_TOL)
    else:
        assert delta is None
    assert logits.dtype == torch.float32 and logits.shape == (3, 2 * P, 2 * P, C)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=HEAD_TOL)


def test_head_initialisers_follow_flax():
    """variance_scaling(2, fan_out, normal) convolutions, normal(0.001)
    predictor, zero predictor_delta and biases."""
    head = tmask.MaskRCNNConvUpsampleHead(64, 80, num_conv=1, conv_dim=256, finetune=True,
                                          generator=torch.Generator().manual_seed(0))
    fan_out = {"mask_fcn1": 9 * 256, "deconv": 4 * 256}
    for name, fan in fan_out.items():
        w = getattr(head, name).weight
        assert abs(float(w.detach().std()) / np.sqrt(2.0 / fan) - 1) < 0.05, name
        assert not getattr(head, name).bias.any()
    assert abs(float(head.predictor.weight.detach().std()) / 1e-3 - 1) < 0.05
    assert not head.predictor_delta.weight.any() and not head.predictor_delta.bias.any()
    assert tuple(head.deconv.weight.shape) == (256, 256, 2, 2)  # [in, out, kh, kw]


@pytest.mark.parametrize("finetune", [False, True])
def test_deconv_weight_round_trip(finetune):
    """load_jax_params and flax_leaves invert each other on every leaf of
    the head, the flipped deconv kernel included, and its gradient comes back
    in the flax layout."""
    jhead, params, thead = head_pair(0, finetune)
    want = flatten_tree(jax.tree.map(np.asarray, params))
    got = flax_leaves(thead)
    assert set(got) == set(want) and "deconv/kernel" in got
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # the kernel's gradient of one scalar of the logits
    x = features()

    def jloss(p):
        out = jhead.apply({"params": p}, jnp.asarray(x), return_delta=finetune)
        out = out[0] + out[1] if finetune else out
        return jnp.sum(out * jnp.arange(C, dtype=jnp.float32))

    jgrads = flatten_tree(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    logits, delta = thead(t(x))
    out = logits + delta if finetune else logits
    (out * torch.arange(C, dtype=torch.float32)).sum().backward()
    tgrads = flax_leaves(thead, grads=True)
    for path, g in jgrads.items():
        np.testing.assert_allclose(tgrads[path], g, atol=1e-4 * np.abs(g).max(), err_msg=path)


@pytest.mark.parametrize("in_ch", [IN_CH, CONV_DIM])
def test_the_generic_kernel_rule_is_wrong_for_deconv(in_ch):
    """The rule of an ordinary convolution ([out, in, kh, kw], unflipped)
    fails on shape when in != out and gives other values when in == out."""
    jhead, params, thead = head_pair(0, False, in_ch=in_ch)
    kernel = np.asarray(params["deconv"]["kernel"])  # HWIO [2, 2, in, out]
    generic = torch.as_tensor(kernel.transpose(3, 2, 0, 1).copy())  # [out, in, 2, 2]
    x = t(features(in_ch=in_ch)).permute(0, 3, 1, 2)
    weight, bias = thead.deconv.weight.detach(), thead.deconv.bias.detach()
    right = F.conv_transpose2d(x, weight, bias, stride=2)
    if in_ch != CONV_DIM:
        with pytest.raises(RuntimeError):
            F.conv_transpose2d(x, generic, bias, stride=2)
        return
    wrong = F.conv_transpose2d(x, generic, bias, stride=2)
    assert float((wrong - right).abs().max()) > 0.1


@pytest.mark.parametrize("per_roi", [False, True])
def test_transfer_mask_logits_matches(per_roi):
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 4, 4, C).astype(np.float32)
    shape = (3, len(NOVEL_IDS), len(BASE_IDS)) if per_roi else (len(NOVEL_IDS), len(BASE_IDS))
    sim = rng.rand(*shape).astype(np.float32)
    want = jmask.transfer_mask_logits(jnp.asarray(logits), jnp.asarray(sim), BASE_IDS, NOVEL_IDS)
    got = tmask.transfer_mask_logits(t(logits), t(sim), BASE_IDS, NOVEL_IDS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FN_TOL)
    np.testing.assert_array_equal(got[..., BASE_IDS].numpy(), logits[..., BASE_IDS])


def mask_case(n=12, mg=28, seed=4):
    """GT-box-frame masks (a blob each), their GT boxes, and ROIs around them:
    overlapping, shifted, larger, partly and fully outside the GT box."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:mg, :mg] / mg
    cy, cx, r = rng.uniform(0.3, 0.7, (3, n, 1, 1))
    masks = ((yy - cy) ** 2 + (xx - cx) ** 2 < (r * 0.6) ** 2).astype(np.float32)
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    shift = rng.uniform(-0.6, 0.6, (n, 2)) * wh
    scale = rng.uniform(0.5, 1.8, (n, 1))
    roi = np.concatenate([xy + shift, xy + shift + wh * scale], 1).astype(np.float32)
    roi[0] = gt[0]                      # the GT box itself
    roi[1] = gt[1] + [200, 200, 200, 200]  # fully outside
    roi[2] = [gt[2, 0], gt[2, 1], gt[2, 0], gt[2, 1]]  # degenerate
    classes = rng.randint(0, C, n).astype(np.int32)
    fg = rng.rand(n) < 0.7
    fg[:2] = True
    return masks, gt, roi, classes, fg


@pytest.mark.parametrize("out_size", [14, 28])
def test_crop_mask_to_box_matches(out_size):
    masks, gt, roi, _, _ = mask_case()
    want = jax.vmap(lambda m, g, r: jmask.crop_mask_to_box(m, g, r, out_size))(
        jnp.asarray(masks), jnp.asarray(gt), jnp.asarray(roi))
    got = tmask.crop_mask_to_box(t(masks), t(gt), t(roi), out_size)
    assert got.shape == (len(masks), out_size, out_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FN_TOL)
    assert got[0].sum() > 0 and not got[1].any()


@pytest.mark.parametrize("all_background", [False, True])
def test_mask_rcnn_loss_and_gradient_match(all_background):
    masks, gt, roi, classes, fg = mask_case()
    if all_background:
        fg[:] = False
    logits = np.random.RandomState(5).randn(len(masks), 28, 28, C).astype(np.float32) * 2

    def jloss(lg):
        return jmask.mask_rcnn_loss(lg, jnp.asarray(classes), jnp.asarray(masks),
                                    jnp.asarray(gt), jnp.asarray(roi), jnp.asarray(fg))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    loss = tmask.mask_rcnn_loss(lg, t(classes), t(masks), t(gt), t(roi), t(fg))
    loss.backward()
    got = loss.detach()
    np.testing.assert_allclose(float(got), float(want), atol=FN_TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), atol=GRAD_ATOL)
    if all_background:
        assert float(got) == 0.0 and not lg.grad.any()


def test_mask_rcnn_inference_matches():
    rng = np.random.RandomState(6)
    logits = rng.randn(5, 28, 28, C).astype(np.float32) * 3
    classes = np.asarray([0, 5, 2, 2, 7], np.int32)  # 7 is clipped to the last channel
    want = jmask.mask_rcnn_inference(jnp.asarray(logits), jnp.asarray(classes))
    got = tmask.mask_rcnn_inference(t(logits), t(classes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FN_TOL)
