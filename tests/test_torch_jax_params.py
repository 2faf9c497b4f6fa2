"""load_jax_params: flax trees into the port's modules, strictly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unit_tpu.models.predictors import SupervisedPredictor as JSup
from unit_tpu.models.resnet import ResNetC4 as JResNetC4
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, load_jax_params
from unit_tpu_torch.models.predictors import SupervisedPredictor
from unit_tpu_torch.models.resnet import ResNetC4


def numpy_tree(module, *inputs):
    params = module.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in inputs))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def resnet_tree():
    return numpy_tree(JResNetC4(depth=26, res2_out_channels=32), np.zeros((1, 32, 32, 3)))


def test_every_leaf_lands_in_place(resnet_tree):
    model = load_jax_params(ResNetC4(depth=26, res2_out_channels=32), resnet_tree)
    flat = flatten_tree(resnet_tree)
    targets = dict(model.named_parameters()) | dict(model.named_buffers())
    assert len(flat) == len(targets)
    k = flat["res3/block0/conv2/kernel"]  # HWIO
    np.testing.assert_array_equal(model.res3.block0.conv2.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.res4.block0.shortcut_bn.var.numpy(),
                                  flat["res4/block0/shortcut_bn/var"])


def test_dense_kernels_are_transposed():
    tree = numpy_tree(JSup(num_classes=4), np.zeros((2, 16)))
    model = load_jax_params(SupervisedPredictor(16, 4), tree)
    np.testing.assert_array_equal(model.bbox_pred_delta.weight.detach().numpy(),
                                  tree["bbox_pred_delta"]["kernel"].T)
    np.testing.assert_array_equal(model.cls_score_delta.bias.detach().numpy(),
                                  tree["cls_score_delta"]["bias"])


def test_missing_leaf_raises(resnet_tree):
    tree = jax.tree.map(lambda x: x, resnet_tree)
    del tree["res2"]["block0"]["conv1_bn"]["mean"]
    with pytest.raises(KeyError, match="not in the flax tree"):
        load_jax_params(ResNetC4(depth=26, res2_out_channels=32), tree)


def test_extra_leaf_raises(resnet_tree):
    tree = jax.tree.map(lambda x: x, resnet_tree)
    tree["res2"]["block0"]["conv4"] = {"kernel": np.zeros((1, 1, 8, 8), np.float32)}
    with pytest.raises(KeyError, match="no counterpart"):
        load_jax_params(ResNetC4(depth=26, res2_out_channels=32), tree)


def test_misshapen_leaf_raises(resnet_tree):
    tree = jax.tree.map(lambda x: x, resnet_tree)
    tree["stem_conv1"]["kernel"] = np.zeros((7, 7, 3, 65), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(ResNetC4(depth=26, res2_out_channels=32), tree)


def test_buffers_stay_buffers(resnet_tree):
    model = load_jax_params(ResNetC4(depth=26, res2_out_channels=32), resnet_tree)
    assert "stem_conv1_bn.weight" in dict(model.named_buffers())
    assert "stem_conv1.weight" in dict(model.named_parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
