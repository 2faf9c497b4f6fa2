"""The note recipe's model family, module by module: unit_tpu_torch vs unit_tpu.

configs/COCO/COCO-RCNN-50-C4-split1-note.yaml trains WeaklySupervisedRCNNNoMeta
on an InceptionResNetV2 backbone cut at block17 (1088 channels, stride 16)
with the full InceptionResNetV2 tail as its box head (InceptionResNetHead,
1536-d) over 17x17 ROIAlignV2 maps.  Each module of
unit_tpu_torch/models/{backbones,box_heads}.py is held against its flax
counterpart in unit_tpu/models/{backbones,box_heads}.py on shared weights;
the recipe builds under both backbone names, and so does each pairing that
one key makes of it (the Res5 head, masks, the meta head, ResNet-C4 under
the tail), its new module held against unit_tpu's.  The whole recipe against unit_tpu's WSRCNN is
tests/test_torch_note_slice.py, its run loop tests/test_torch_note_run.py.

Weights: He-scaled convolution kernels (randn * sqrt(2 / fan_in)) and
everything else normal(0.1), so that each residual branch moves its block's
output by a visible fraction.

Bounds: modules in f32 within 1e-4 of the output's largest magnitude (the
same f32 convolutions summed in different orders by XLA and oneDNN; a wrong
padding, pool or residual scale moves outputs by percents); bf16: see
test_bf16_against_unit_tpu.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.models import backbones as jbb
from unit_tpu.models import box_heads as jbh
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import backbones as tbb
from unit_tpu_torch.models import box_heads as tbh

NOTE = "configs/COCO/COCO-RCNN-50-C4-split1-note.yaml"
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads while the module runs.  With pytest-xdist's
    workers on one machine, torch's default of one OpenMP thread per core
    oversubscribes it, and each parallel region of these convolutions then
    waits for descheduled threads: the modules here ran ~4x slower with three
    workers on eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def param_shapes(jmodule, *inputs):
    """The parameter tree of ``jmodule`` as shapes (jax.eval_shape: nothing
    is initialised)."""
    return jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                          *(jnp.asarray(x) for x in inputs))["params"]


def he_tree(jmodule, *inputs, seed=0, shapes=None):
    """Parameters of ``jmodule`` as numpy: convolution kernels He-scaled,
    everything else (biases, dense kernels, the embeddings) normal(0.1)."""
    shapes = param_shapes(jmodule, *inputs) if shapes is None else shapes
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:  # HWIO
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:3])))
        return rng.randn(*leaf.shape) * 0.1
    return jax.tree.map(lambda leaf: draw(leaf).astype(np.float32), shapes)


def jit_apply(jmodule, **kw):
    return jax.jit(lambda p, v: jmodule.apply({"params": p}, v, **kw))


def assert_close_rel(got, want, rel=REL):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= rel * scale, f"max|diff| {err} vs {rel} x {scale}"


def nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("block,channels", [("35", 320), ("17", 1088)])
def test_inception_resnet_blocks_match_flax(block, channels):
    """block35 (3x3 branches, scale 0.17) and block17 (1x7 then 7x1, scale
    0.1) on an odd 9x11 map: the asymmetric "SAME" paddings at every border."""
    x = np.random.RandomState(1).randn(2, 9, 11, channels).astype(np.float32)
    jm = getattr(jbb, f"_IRBlock{block}")(dtype=jnp.float32)
    tm = getattr(tbb, f"_IRBlock{block}")(channels)
    params = he_tree(jm, x)
    load_jax_params(tm, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert_close_rel(got, want)
    # the branches matter: the block is not the identity on its input
    assert np.abs(want - np.maximum(x, 0)).max() > 0.05 * np.abs(want).max()


@pytest.mark.parametrize("relu,scale", [(True, 0.2), (False, 1.0)])
def test_block8_matches_flax(relu, scale):
    x = np.random.RandomState(2).randn(3, 8, 8, 2080).astype(np.float32)
    jm = jbh._Block8(scale=scale, relu=relu, dtype=jnp.float32)
    tm = tbh._Block8(2080, scale, relu=relu)
    params = he_tree(jm, x)
    assert "bias" not in params["b1_1"] and "bias" in params["up"]
    load_jax_params(tm, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert_close_rel(got, want)
    assert (want.min() < 0) == (not relu)


@pytest.mark.parametrize("blocks,hw", [((1, 2), (75, 99)), ((10, 20), (96, 96))],
                         ids=["reduced_odd_canvas", "full_depth"])
def test_inception_resnet_v2_matches_flax(blocks, hw):
    x = np.random.RandomState(3).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    jm = jbb.InceptionResNetV2(num_block35=blocks[0], num_block17=blocks[1], dtype=jnp.float32)
    tm = tbb.InceptionResNetV2(*blocks)
    params = he_tree(jm, x)
    load_jax_params(tm, params)
    want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = out.permute(0, 2, 3, 1)
    assert got.is_contiguous()  # the [B, h, w, C] view K1 reads without a copy
    assert got.shape == want.shape and want.shape[-1] == tm.out_channels == 1088
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("p,blocks", [(17, 1), (14, 1), (17, 9)],
                         ids=["P17", "P14", "P17_full_depth"])
def test_inception_resnet_head_matches_flax(p, blocks):
    rois = 4 if blocks == 1 else 3
    x = np.random.RandomState(p + blocks).randn(rois, p, p, 1088).astype(np.float32)
    jm = jbh.InceptionResNetHead(num_block8=blocks, dtype=jnp.float32)
    tm = tbh.InceptionResNetHead(1088, num_block8=blocks)
    params = he_tree(jm, x)
    load_jax_params(tm, params)
    assert tm.out_channels == 1536
    fn = jax.jit(lambda prm, v, m: jm.apply({"params": prm}, v, spatial_mean=m),
                 static_argnums=2)
    side = (p - 3) // 2 + 1  # mixed_7a: a 3x3 stride-2 unpadded reduction
    for mean in (True, False):
        want = np.asarray(fn(params, jnp.asarray(x), mean))
        with torch.no_grad():
            got = tm(torch.as_tensor(x), spatial_mean=mean)
        assert got.dtype == torch.float32
        assert got.shape == want.shape == ((rois, 1536) if mean else (rois, side, side, 1536))
        assert_close_rel(got.numpy(), want)


def test_avg_pool_counts_the_padded_zeros_as_flax_does():
    """mixed_5b's pool branch: flax nn.avg_pool "SAME" divides every window by
    9, border windows too (count_include_pad)."""
    x = np.ones((1, 5, 6, 2), np.float32)
    x[0, 0, 0, 0] = 4.0  # channel 0 only
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1), padding="SAME"))
    got = nhwc(F.avg_pool2d(nchw(x), 3, 1, 1, count_include_pad=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0, 0, 1] == pytest.approx(4 / 9) and got[0, 0, 0, 0] == pytest.approx(7 / 9)
    assert got[0, 0, 3, 0] == pytest.approx(6 / 9) and got[0, 2, 3, 0] == pytest.approx(1.0)


# bf16 compute against unit_tpu in bf16, the reduced backbone and a one-Block8
# head over its pooled map.  Both round every convolution's output and each
# residual's product and sum to bf16 in the same places; they differ in
# summation order and where XLA fuses the bias add and residual arithmetic
# into one rounding, about one bf16 ulp (2^-8 relative) a layer.  The chain
# is ~25 convolutions deep; as in tests/test_torch_resnet.py the errors add
# like a random walk on values of the output's scale: sqrt(25) * 2^-8 ~ 2%.
# Bound: 4% of the largest magnitude for the worst element and 0.5% for the
# mean, for port vs unit_tpu and each against their common f32 result.  (On
# the CPU: backbone port vs unit_tpu max 0.8%, mean 0.04%; head max 0.9%,
# mean 0.2%.)
BF16_MAX_REL, BF16_MEAN_REL = 0.04, 0.005


@pytest.mark.parametrize("part", ["backbone", "head"])
def test_bf16_against_unit_tpu(part):
    rng = np.random.RandomState(11)
    if part == "backbone":
        x = rng.uniform(-1, 1, (2, 75, 99, 3)).astype(np.float32)
        mk_j = lambda dt: jbb.InceptionResNetV2(num_block35=1, num_block17=2, dtype=dt)  # noqa: E731
        tm = tbb.InceptionResNetV2(1, 2, dtype=torch.bfloat16)
    else:
        x = rng.randn(4, 17, 17, 1088).astype(np.float32)
        mk_j = lambda dt: jbh.InceptionResNetHead(num_block8=1, dtype=dt)  # noqa: E731
        tm = tbh.InceptionResNetHead(1088, num_block8=1, dtype=torch.bfloat16)
    params = he_tree(mk_j(jnp.float32), x)
    load_jax_params(tm, params)
    exact = np.asarray(jit_apply(mk_j(jnp.float32))(params, jnp.asarray(x)))
    want = np.asarray(jit_apply(mk_j(jnp.bfloat16))(params, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    if part == "backbone":
        assert out.dtype == torch.bfloat16
        out = out.permute(0, 2, 3, 1)
    got = out.float().numpy()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    scale = float(np.abs(exact).max())
    for a, b in ((got, want), (got, exact), (want, exact)):
        diff = np.abs(a - b)
        assert diff.max() <= BF16_MAX_REL * scale, diff.max() / scale
        assert diff.mean() <= BF16_MEAN_REL * scale, diff.mean() / scale


# ------------------------------------------------------------ the recipe
def note_cfgs(*opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(NOTE)
        cfg.merge_from_list(list(opts))
    return jcfg, tcfg


@pytest.mark.parametrize("name", ["InceptionResNetV2", "build_inception_resnet_v2_backbone"])
def test_the_note_model_builds_under_both_backbone_names(name):
    _, tcfg = note_cfgs("MODEL.BACKBONE.NAME", name)
    mc = ModelConfig.from_cfg(tcfg)
    assert (mc.rpn_conv_dim, mc.pooler_resolution, mc.roi_batch_size) == (1088, 17, 300)
    assert mc.num_classes == 80 and not mc.multi_box_head and not mc.mask_on
    with torch.device("meta"):  # shapes and structure; no 66 M weights to draw
        model = WSRCNN(mc)
    assert isinstance(model.backbone, tbb.InceptionResNetV2)
    assert isinstance(model.box_head, tbh.InceptionResNetHead)
    assert model.rpn_head.conv.weight.shape == (1088, 1088, 3, 3)
    assert model.supervised.cls_score_delta.weight.shape[1] == 1536
    assert not hasattr(model, "weak_box_head")
    # no FrozenBN on this path: the epilogue switch has nothing to route
    from unit_tpu_torch.models.resnet import FrozenBN, set_bn_act_impl

    assert not any(isinstance(m, FrozenBN) for m in model.modules())
    set_bn_act_impl(model, "plain")


@pytest.mark.parametrize("opts", [
    ("MODEL.ROI_BOX_HEAD.NAME", "Res5BoxHead"),
    ("MODEL.MASK_ON", "True"),
    ("MODEL.ROI_HEADS.NAME", "WSROIHead"),
    ("MODEL.BACKBONE.NAME", "build_resnet_backbone"),
], ids=["res5_over_inception", "mask_head", "meta_head", "inception_head_over_resnet"])
def test_pairs_no_recipe_ships_raise(opts):
    """The note recipe with one key changed, which raised before these
    pairings were ported and now builds over the backbone's width (shapes,
    on the meta device); the module the key brings in is held against
    unit_tpu's on shared weights, at the note's shapes: a Res5 over block17's
    1088 channels at P = 17 (its stride-2 1x1 takes 17 to 9, as flax's
    "SAME" does), the mask head over the tail's [N, 8, 8, 1536] map (16 x 16
    logits), the visual attention head's prototypes of 17 x 17 shots over
    1088 channels, the tail over ResNet-C4's 1024 channels at P = 14.  The
    whole models: tests/test_torch_pair_paths.py, tests/test_torch_pairs.py."""
    from tests.test_full_graph_torch_parity import randomize_params
    from unit_tpu.models import mask_head as jmask
    from unit_tpu.models import resnet as jres
    from unit_tpu.models import visual_attention as jva
    from unit_tpu_torch.models import mask_head as tmask
    from unit_tpu_torch.models import resnet as tres
    from unit_tpu_torch.models import visual_attention as tva

    _, tcfg = note_cfgs(*opts)
    with torch.device("meta"):
        model = WSRCNN(ModelConfig.from_cfg(tcfg))
    c = model.backbone.out_channels
    rng = np.random.RandomState(len(opts[1]))
    case = opts[1]
    if case == "Res5BoxHead":
        assert model.box_head.res5.block0.shortcut.weight.shape[1] == c == 1088
        x = rng.randn(2, 17, 17, 1088).astype(np.float32)
        jm, tm = jres.Res5(depth=50), tres.Res5(depth=50, in_channels=1088)
        params = jax.tree.map(np.asarray, randomize_params(param_shapes(jm, x), seed=1))
        load_jax_params(tm, params)
        want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, spatial_mean=False))(
            params, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.as_tensor(x), spatial_mean=False).numpy()
        assert got.shape == want.shape == (2, 9, 9, 2048)
    elif case == "True":
        assert model.mask_head.deconv.weight.shape[0] == model.box_head.out_channels == 1536
        x = rng.randn(3, 8, 8, 1536).astype(np.float32)
        jm, tm = jmask.MaskRCNNConvUpsampleHead(num_classes=80), \
            tmask.MaskRCNNConvUpsampleHead(1536, 80)
        params = he_tree(jm, x)
        load_jax_params(tm, params)
        want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.as_tensor(x))[0].numpy()
        assert got.shape == want.shape == (3, 16, 16, 80)
    elif case == "WSROIHead":
        block0 = model.visual_attention.meta_box_head.res5.block0
        assert block0.conv1.weight.shape[1] == block0.shortcut.weight.shape[1] == c == 1088
        feats = rng.randn(2, 2, 10, 12, 1088).astype(np.float32)
        boxes = np.asarray([[[8, 8, 120, 150], [0, 0, 160, 190]],
                            [[30, 20, 90, 100], [50, 60, 170, 180]]], np.float32)
        valid, base = np.asarray([True, True]), np.asarray([3, 40])
        jm = jva.VisualAttentionHead(num_classes=80, pooler_resolution=17)
        tm = tva.VisualAttentionHead(80, in_channels=1088, pooler_resolution=17,
                                     roi_align_impl="plain")
        shapes = jax.eval_shape(lambda f, b, v: jm.init(
            jax.random.PRNGKey(0), f, b, v, base,
            method=jva.VisualAttentionHead.support_prototypes), feats, boxes, valid)["params"]
        params = jax.tree.map(np.asarray, randomize_params(shapes, seed=2))
        params["rank_loss_classifier"] = {
            "kernel": np.zeros((2048, 81), np.float32), "bias": np.zeros(81, np.float32)}
        load_jax_params(tm, params)
        want = np.asarray(jax.jit(lambda p, f, b, v: jm.apply(
            {"params": p}, f, b, v, base, method=jva.VisualAttentionHead.support_prototypes
        ).mean)(params, *(jnp.asarray(a) for a in (feats, boxes, valid))))
        with torch.no_grad():
            got = tm.support_prototypes(*(torch.as_tensor(a) for a in (feats, boxes, valid)),
                                        base).mean.numpy()
        assert got.shape == want.shape == (81, 2048) and np.abs(want[base]).max(-1).min() > 0
    else:
        assert model.box_head.m7a_b0_0.weight.shape[1] == c == 1024
        x = rng.randn(3, 14, 14, 1024).astype(np.float32)
        jm, tm = jbh.InceptionResNetHead(num_block8=1), tbh.InceptionResNetHead(1024, 1)
        params = he_tree(jm, x)
        load_jax_params(tm, params)
        want = np.asarray(jit_apply(jm)(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.as_tensor(x)).numpy()
        assert got.shape == want.shape == (3, 1536)
    assert_close_rel(got, want)


def test_seeded_init_follows_flax_initialisers():
    tm = tbh.InceptionResNetHead(1088, num_block8=1, generator=torch.Generator().manual_seed(3))
    w = tm.block8_0.b1_1.weight.detach()  # a 1x3 kernel: fan_in 192 * 3
    assert w.shape == (224, 192, 1, 3)
    std = (1.0 / (192 * 3)) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) - std) < 0.1 * std
    assert tm.block8_0.b1_1.bias is None and bool((tm.block8_0.up.bias == 0).all())
    bb = tbb.InceptionResNetV2(1, 1, generator=torch.Generator().manual_seed(3))
    assert bb.block17_0.b1_2.weight.shape == (192, 160, 7, 1)
    assert bool((bb.block17_0.b1_2.bias == 0).all())
