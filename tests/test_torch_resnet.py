"""ResNet-C4 backbone and Res5 head in unit_tpu_torch vs flax (unit_tpu), f32.

Shared random weights (FrozenBN statistics included) go through
load_jax_params.  The bound is 1e-4 of the output's largest magnitude: both
sides run the same f32 convolutions, summed in different orders by XLA and
oneDNN over up to 3x3x1024 terms per output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from unit_tpu.models.resnet import Res5 as JRes5
from unit_tpu.models.resnet import ResNetC4 as JResNetC4
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.models.resnet import Res5, ResNetC4

REL = 1e-4


def assert_close_rel(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"max|diff| {err} vs {REL} x {scale}"


def shared(jmodule, tmodule, x):
    params = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, randomize_params(params, seed=1))
    load_jax_params(tmodule, params)
    return params


@pytest.mark.parametrize("res2", [256, 32])  # published width, and a narrow one
def test_resnet_c4_matches_flax(res2):
    rng = np.random.RandomState(res2)
    x = rng.uniform(-100, 100, (2, 64, 96, 3)).astype(np.float32)
    jm = JResNetC4(depth=26, res2_out_channels=res2, dtype=jnp.float32)
    tm = ResNetC4(depth=26, res2_out_channels=res2).eval()
    params = shared(jm, tm, x[:1])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = out.permute(0, 2, 3, 1)
    assert got.is_contiguous()  # the [B, H, W, C] view ROIAlign reads without a copy
    assert got.shape == want.shape == (2, 4, 6, res2 * 4)
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("res2", [256, 32])
def test_res5_matches_flax(res2):
    rng = np.random.RandomState(res2 + 1)
    x = rng.randn(5, 14, 14, res2 * 4).astype(np.float32)
    jm = JRes5(depth=26, res2_out_channels=res2, dtype=jnp.float32)
    tm = Res5(depth=26, res2_out_channels=res2).eval()
    params = shared(jm, tm, x[:1])
    for mean in (True, False):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), spatial_mean=mean))
        with torch.no_grad():
            got = tm(torch.as_tensor(x), spatial_mean=mean).numpy()
        assert got.shape == want.shape
        assert_close_rel(got, want)


def test_bf16_compute_keeps_f32_params():
    """COMPUTE_DTYPE bfloat16: convs and FrozenBN run in bf16, weights stay f32."""
    tm = ResNetC4(depth=26, res2_out_channels=32, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = tm(torch.rand(1, 64, 64, 3) * 255)
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert torch.isfinite(out.float()).all()


def test_seeded_init_follows_flax_initialisers():
    tm = ResNetC4(depth=26, res2_out_channels=32, generator=torch.Generator().manual_seed(3))
    w = tm.res4.block0.conv2.weight.detach()
    fan_in = w.shape[1] * 9
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6  # truncated at two sigma
    assert abs(float(w.std()) - (1.0 / fan_in) ** 0.5) < 0.1 * (1.0 / fan_in) ** 0.5
    bn = tm.res4.block0.conv2_bn
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                and (bn.mean == 0).all() and (bn.var == 1).all())
    again = ResNetC4(depth=26, res2_out_channels=32, generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.res4.block0.conv2.weight, tm.res4.block0.conv2.weight)
