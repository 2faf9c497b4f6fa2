"""The dock recipe's model family, module by module: unit_tpu_torch vs unit_tpu.

configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml trains WeaklySupervisedRCNNNoMeta
on the Caffe VGG-CNN-F (local response norm after conv1 and conv2, 256
channels, stride 16) with ROIPool at 6x6 into the VGG fc head (fc6 9216 ->
4096, fc7 4096 -> 4096, dropout 0.5 after each ReLU in training).  Each
module of unit_tpu_torch/models/{backbones,box_heads}.py and
unit_tpu_torch/ops/roi_pool.py is held against its counterpart in
unit_tpu/models/{backbones,box_heads}.py and unit_tpu/ops/roi_align.py on
shared weights and seeded numpy inputs, at full width (unit_tpu's modules
have no width knob); VGG16 (plain and dilated), which no recipe ships, too.
The regression branches and OICR_ITER 0 are tests/test_torch_dock_weak.py,
the data path tests/test_torch_dock_data.py and the whole recipe
tests/test_torch_dock_slice.py.

Weights: tests/test_torch_note.py's he_tree (He-scaled convolution kernels,
normal(0.1) elsewhere).  Bounds: f32 outputs within 1e-4 of the largest
magnitude (REL, the same f32 sums in other orders); ROIPool's forward is a
max of gathered values, so exact, and its gradient sums the same f32 shares
(within 1e-6 of the largest element); dropout: see test_dropout_*.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_note import assert_close_rel, he_tree, jit_apply
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.models import backbones as jbb
from unit_tpu.models import box_heads as jbh
from unit_tpu.ops.roi_align import roi_pool_max as jroi_pool_max
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import backbones as tbb
from unit_tpu_torch.models import box_heads as tbh
from unit_tpu_torch.ops.roi_pool import roi_pool_max

DOCK = "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"


def nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def lrn_formula(x):
    """Caffe LRN on NHWC numpy: x / (2 + 1e-4 * sum of x^2 over 5 channels)^0.75."""
    sq = np.pad(x.astype(np.float64) ** 2, [(0, 0)] * 3 + [(2, 2)])
    acc = sum(sq[..., i:i + x.shape[-1]] for i in range(5))
    return x / (2.0 + 1e-4 * acc) ** 0.75


def test_local_response_norm_is_caffes_formula_and_unit_tpus():
    # values of ~60, so that alpha * S (~0.3 + ...) moves the result
    x = np.random.RandomState(0).randn(2, 5, 7, 16).astype(np.float32) * 60.0
    want = np.asarray(jbb.LocalResponseNorm().apply({}, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tbb.LocalResponseNorm()(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, lrn_formula(x), rtol=1e-5)
    # torch's LRN divides alpha by the size and defaults k to 1: not this
    other = nhwc(F.local_response_norm(nchw(x), 5, 1e-4, 0.75, 2.0))
    assert np.abs(other - got).max() > 1e-3 * np.abs(got).max()


def vgg_cnn_f_map_side(n):
    """conv1 11x11/4 unpadded, then two 3x3/2 pools over one padded row."""
    n = (n - 11) // 4 + 1
    for _ in range(2):
        n = (n + 1 - 3) // 2 + 1
    return n


@pytest.mark.parametrize("hw", [(99, 131), (128, 160), (160, 224)])
def test_vgg_cnn_f_matches_unit_tpu(hw):
    """Odd and even sides: the -inf row and column of each pool is the last
    window's only padding where (side after conv) is even."""
    x = np.random.RandomState(hw[0]).uniform(-100, 100, (2,) + hw + (3,)).astype(np.float32)
    jm = jbb.VGGCNNF(dtype=jnp.float32)
    tm = tbb.VGGCNNF()
    params = he_tree(jm, x)
    assert set(params) == {f"conv{i}" for i in range(1, 6)}  # LRN has no parameters
    load_jax_params(tm, params)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = out.permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, vgg_cnn_f_map_side(hw[0]),
                                       vgg_cnn_f_map_side(hw[1]), 256)
    assert_close_rel(got.numpy(), want)


def test_the_pools_pad_minus_infinity_at_the_bottom_and_right_only():
    x = -np.abs(np.random.RandomState(4).randn(1, 6, 6, 2)).astype(np.float32) - 1.0
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), ((0, 1), (0, 1))))
    got = nhwc(tbb._max_pool_bottom_right(nchw(x)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, 3, 3, 2)
    # a zero pad (or max_pool2d's own, on both sides) would raise these
    # all-negative windows to 0
    assert (got < 0).all()


def test_the_dock_canvas_gives_a_49x83_map():
    with torch.device("meta"):  # shapes only
        out = tbb.VGGCNNF()(torch.empty(1, 800, 1344, 3))
    assert tuple(out.shape) == (1, 256, 49, 83)
    assert (vgg_cnn_f_map_side(800), vgg_cnn_f_map_side(1344)) == (49, 83)


@pytest.mark.parametrize("dilated", [False, True], ids=["plain", "dilated"])
def test_vgg16_matches_unit_tpu(dilated):
    """Four 2x2 pools (floor) on a 70x90 input -> 4x5; under DILATED conv5
    reads taps two cells apart with a pad of 2 and keeps every pool, as
    unit_tpu's code does (its docstring says the last pool is dropped)."""
    x = np.random.RandomState(5).uniform(-100, 100, (1, 70, 90, 3)).astype(np.float32)
    jm = jbb.VGG16(dilated=dilated, dtype=jnp.float32)
    tm = tbb.VGG16(dilated=dilated)
    params = he_tree(jm, x)
    assert set(params) == {f"conv{i}" for i in range(13)}
    load_jax_params(tm, params)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 4, 5, 512) and tm.out_channels == 512
    assert_close_rel(got, want)
    assert tm.conv12.dilation == (2 if dilated else 1) == tm.conv12.padding


@pytest.fixture(scope="module")
def fc_params():
    """One seeded tree of the fc head (both names build the same module in
    both packages): 54.5 M draws, made once."""
    x = np.random.RandomState(6).randn(5, 6, 6, 256).astype(np.float32)
    return x, he_tree(jbh.VGGCNNFBoxHead(dtype=jnp.float32), x)


@pytest.mark.parametrize("name", ["VGGConvFCHead", "VGGCNNFBoxHead"])
def test_fc_heads_match_unit_tpu(name, fc_params):
    """fc6 over the (h, w, c)-flattened 6x6x256 ROI (9216 -> 4096) and fc7:
    the converter only transposes the kernels."""
    x, params = fc_params
    jm = jbh.BOX_HEAD_REGISTRY.get(name)(dtype=jnp.float32)
    tm = tbh.build_box_head(name, 256, pooler_resolution=6)
    assert params["fc"]["fc6"]["kernel"].shape == (9216, 4096)
    load_jax_params(tm, params)
    assert tm.fc.fc6.weight.shape == (4096, 9216) and tm.out_channels == 4096
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (5, 4096)
    assert_close_rel(got.numpy(), want)
    # a (c, h, w) flattening would read other weights
    with torch.no_grad():
        wrong = tm(torch.as_tensor(x).permute(0, 3, 1, 2).reshape(5, 6, 6, 256))
    assert np.abs(wrong.numpy() - want).max() > 0.01 * np.abs(want).max()


def test_dropout_rate_scale_and_seed():
    """Units kept with probability 0.5 (within 5 sigma of a binomial over
    400k draws) and doubled; the same generator seed gives the same mask,
    another seed another."""
    x = torch.ones(100, 4000)

    def drop(seed):
        return tbh.dropout(x, 0.5, torch.Generator().manual_seed(seed))

    a, b, c = drop(1), drop(1), drop(2)
    kept = (a != 0).float().mean().item()
    sigma = (0.25 / x.numel()) ** 0.5
    assert abs(kept - 0.5) < 5 * sigma, kept
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_only_with_a_generator():
    """The head drops units after fc6 and fc7 only when given a generator:
    the same head in train or eval mode without one is deterministic; with
    the same seed twice it is the same."""
    torch.manual_seed(0)
    tm = tbh.build_box_head("VGGCNNFBoxHead", 16, pooler_resolution=6,
                            generator=torch.Generator().manual_seed(0))
    x = torch.rand(8, 6, 6, 16)
    with torch.no_grad():
        plain = tm(x)
        tm.train()
        assert torch.equal(tm(x), plain)
        d1 = tm(x, dropout_generator=torch.Generator().manual_seed(3))
        d2 = tm(x, dropout_generator=torch.Generator().manual_seed(3))
    assert torch.equal(d1, d2) and not torch.equal(d1, plain)
    # fc7's own dropout zeroes about half of its units
    assert (d1 == 0).float().mean() > 0.4


def rois_with_ties(rng, n, h_img, w_img):
    """ROIs of every kind ROIPool meets: sub-cell ones (one cell sampled up
    to four times a bin: ties), thin ones, large ones, ones past the image
    (clamped samples), zero-size ones."""
    x1 = rng.uniform(-40, w_img, n)
    y1 = rng.uniform(-40, h_img, n)
    wh = np.where(rng.rand(n, 2) < 0.4, rng.uniform(0, 12, (n, 2)),
                  rng.uniform(12, max(h_img, w_img), (n, 2)))
    rois = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], -1)
    rois[:3] = [[10, 10, 10, 10], [0, 0, 3, 3], [50, 20, 51, 200]]
    return rois.astype(np.float32)


@pytest.mark.parametrize("p", [6, 7])
def test_roi_pool_matches_unit_tpu_forward_and_gradient(p):
    rng = np.random.RandomState(p)
    b, h, w, c, n = 2, 9, 13, 8, 40
    # integers in [0, 3]: equal values in different cells tie too
    feats = rng.randint(0, 4, (b, h, w, c)).astype(np.float32)
    rois = np.stack([rois_with_ties(rng, n, 16 * h, 16 * w) for _ in range(b)])
    gout = rng.randn(b, n, p, p, c).astype(np.float32)

    def jfn(f):
        out = jax.vmap(lambda fi, ri: jroi_pool_max(fi, ri, p, 1 / 16))(f, jnp.asarray(rois))
        return jnp.sum(out * gout), out

    (_, want), gwant = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(feats))
    ft = torch.as_tensor(feats).requires_grad_(True)
    got = roi_pool_max(ft, torch.as_tensor(rois), p, 1 / 16)
    (got * torch.as_tensor(gout)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gw = np.asarray(gwant)
    assert np.abs(ft.grad.numpy() - gw).max() <= 1e-6 * np.abs(gw).max()
    assert (gw != 0).any()


def test_roi_pool_splits_the_gradient_among_ties():
    """One ROI inside one cell: each of a bin's 4 samples reads that cell,
    so the cell gets the bin's gradient once (4 shares of 1/4), in both."""
    feats = np.zeros((1, 4, 4, 1), np.float32)
    feats[0, 1, 2, 0] = 5.0
    rois = np.asarray([[[33.0, 17.0, 34.0, 18.0]]], np.float32)  # inside cell (1, 2)
    ft = torch.as_tensor(feats).requires_grad_(True)
    out = roi_pool_max(ft, torch.as_tensor(rois), 2, 1 / 16)
    assert (out == 5.0).all()
    out.sum().backward()
    jg = jax.grad(lambda f: jroi_pool_max(f[0], jnp.asarray(rois[0]), 2, 1 / 16).sum())(
        jnp.asarray(feats))
    np.testing.assert_array_equal(ft.grad.numpy(), np.asarray(jg))
    assert ft.grad[0, 1, 2, 0] == 4.0 and ft.grad.sum() == 4.0


@pytest.mark.parametrize("name", ["VGG_CNN_F", "build_vgg_cnn_f_backbone"])
def test_the_dock_model_builds_under_both_backbone_names(name):
    cfg = get_cfg()
    cfg.merge_from_file(DOCK)
    cfg.merge_from_list(["MODEL.BACKBONE.NAME", name])
    mc = ModelConfig.from_cfg(cfg)
    assert (mc.rpn_conv_dim, mc.pooler_resolution, mc.pooler_type) == (256, 6, "ROIPool")
    assert mc.load_proposals and mc.num_classes == 80 and mc.roi_batch_size == 512
    with torch.device("meta"):  # shapes and structure; no 60 M weights to draw
        model = WSRCNN(mc)
    assert isinstance(model.backbone, tbb.VGGCNNF)
    assert isinstance(model.box_head, tbh.VGGFCHead)
    assert model.box_head.fc.fc6.weight.shape == (4096, 9216)
    assert model.supervised.cls_score_delta.weight.shape == (81, 4096)
    assert not hasattr(model, "weak_box_head")


@pytest.mark.parametrize("name,dilated", [("VGG", False), ("build_vgg_backbone", True)])
def test_vgg16_models_build(name, dilated):
    cfg = get_cfg()
    cfg.merge_from_file(DOCK)
    cfg.merge_from_list(["MODEL.BACKBONE.NAME", name, "MODEL.BACKBONE.DILATED", str(dilated),
                         "MODEL.ROI_BOX_HEAD.NAME", "VGGConvFCHead",
                         "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "7"])
    mc = ModelConfig.from_cfg(cfg)
    with torch.device("meta"):
        model = WSRCNN(mc)
    assert mc.rpn_conv_dim == 512 and mc.backbone_dilated == dilated
    assert model.box_head.fc.fc6.weight.shape == (4096, 7 * 7 * 512)
    assert model.backbone.conv12.dilation == (2 if dilated else 1)
