"""fold_frozen_bn in unit_tpu_torch: the cases of tests/test_bn_fold.py on the
module tree, and the folded tensors against unit_tpu's fold leaf by leaf.

Bounds: the fold is exact in real arithmetic and moves one f32 rounding per
convolution, so folded f32 outputs agree with unfolded ones to rtol 2e-4 /
atol 2e-5 (the bound of tests/test_bn_fold.py); the folded tensors equal
unit_tpu's to 1e-6 of each leaf's largest magnitude (the same two f32 ops,
FMA contraction aside).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from unit_tpu.models.resnet import ResNetC4 as JResNetC4
from unit_tpu.utils.bn_fold import fold_frozen_bn as jfold
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_path, to_flax_layout
from unit_tpu_torch.models.resnet import FrozenBN, ResNetC4
from unit_tpu_torch.utils.bn_fold import fold_frozen_bn


@pytest.fixture(scope="module")
def pair():
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32) * 255
    jm = JResNetC4(depth=26, res2_out_channels=32, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    params = jax.tree.map(np.asarray, randomize_params(params, seed=2))
    tm = ResNetC4(depth=26, res2_out_channels=32).eval()
    load_jax_params(tm, params)
    return jm, params, tm, x


def all_leaves(model):
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        out[flax_path(name, t)] = to_flax_layout(t.detach().numpy())
    return out


def test_fold_structure_and_identity(pair):
    _, _, tm, _ = pair
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    folded = fold_frozen_bn(tm)
    assert folded is not tm
    # the model itself is left as it is (it may be in training)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    assert list(folded.state_dict()) == list(before)
    assert all(v.shape == before[k].shape for k, v in folded.state_dict().items())
    bns = [m for m in folded.modules() if isinstance(m, FrozenBN)]
    assert len(bns) == 13  # stem + res2, res3, res4 x (3 convs + shortcut) at depth 26
    for bn in bns:
        scale, _ = bn.scale_shift()
        assert bool((bn.weight == 1).all() and (bn.mean == 0).all())
        assert torch.equal(scale, torch.ones_like(scale))  # sqrt(var + eps) is exactly 1
    assert not torch.allclose(folded.stem_conv1.weight, tm.stem_conv1.weight)


def test_backbone_forward_equality_fp32(pair):
    _, _, tm, x = pair
    with torch.no_grad():
        y0 = tm(torch.as_tensor(x))
        y1 = fold_frozen_bn(tm)(torch.as_tensor(x))
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-4, atol=2e-5)


def test_fold_is_idempotent(pair):
    _, _, tm, _ = pair
    once = fold_frozen_bn(tm)
    twice = fold_frozen_bn(once)
    for (k, a), (_, b) in zip(once.state_dict().items(), twice.state_dict().items()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_folded_tensors_match_unit_tpu(pair):
    _, params, tm, _ = pair
    want = flatten_tree(jax.tree.map(np.asarray, jfold(jax.tree.map(jnp.asarray, params))))
    got = all_leaves(fold_frozen_bn(tm))
    assert set(got) == set(want)
    for path, w in want.items():
        bound = 1e-6 * max(1.0, float(np.abs(w).max()))
        assert np.abs(got[path] - w).max() <= bound, path


def test_folded_bf16_forward_stays_close(pair):
    """bf16 compute: the fold moves a rounding from the epilogue's f32 scale to
    the weight's cast, so outputs differ at bf16 resolution: 4% of the
    output's largest magnitude covers three stages of bf16 convolutions."""
    _, params, _, x = pair
    tm = ResNetC4(depth=26, res2_out_channels=32, dtype=torch.bfloat16).eval()
    load_jax_params(tm, params)
    with torch.no_grad():
        y0 = tm(torch.as_tensor(x)).float()
        y1 = fold_frozen_bn(tm)(torch.as_tensor(x)).float()
    assert float((y1 - y0).abs().max()) <= 0.04 * float(y0.abs().max())


def test_detection_service_folds_when_asked():
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.serving import DetectionService

    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                         "MODEL.RPN.PRE_NMS_TOPK_TEST", "60", "MODEL.RPN.POST_NMS_TOPK_TEST", "12",
                         "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
                         "TPU.COMPUTE_DTYPE", "float32", "TPU.FOLD_BN_AT_EVAL", "True"])
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(0)
    for m in model.modules():
        if isinstance(m, FrozenBN):
            m.weight.copy_(torch.as_tensor(0.5 + rng.rand(*m.weight.shape)))
            m.var.copy_(torch.as_tensor(0.5 + rng.rand(*m.var.shape)))
            m.mean.copy_(torch.as_tensor(rng.randn(*m.mean.shape) * 0.2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    image = rng.uniform(0, 255, (50, 70, 3)).astype(np.float32)
    got = DetectionService(cfg, model).detect_array(image)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    cfg.TPU.FOLD_BN_AT_EVAL = False
    want = DetectionService(cfg, model).detect_array(image)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["class_id"] == w["class_id"] and abs(g["score"] - w["score"]) < 2e-3
        assert np.abs(np.subtract(g["box"], w["box"])).max() < 0.05
