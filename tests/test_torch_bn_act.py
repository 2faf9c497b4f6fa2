"""The fused FrozenBN + residual + ReLU epilogue (K4) in unit_tpu_torch.

On the CPU: ``bn_act_plain`` against unit_tpu's FrozenBN + add + relu chain in
f32 (rtol 1e-6: the same three or four f32 ops, XLA may contract a multiply
and an add into one FMA), against ``ep_kernel``'s expression written out in
numpy (scripts/bench_backbone_epilogue.py:145: the TPU kernel itself builds
only on a TPU), its autograd gradient against ``jax.grad`` of the chain, and
the backward formula the CUDA kernel implements against autograd (exact).

The kernel tests need the card and are skipped elsewhere; this file imports
jax only inside the tests that compare with unit_tpu, so they also run on the
card's machine (no jax).  Gate there: bit-identical to the plain version, in
f32 and bf16, forward and backward: the kernel does the plain version's f32
ops in its order with no FMA contraction, and both round once.
"""

import numpy as np
import pytest
import torch

from unit_tpu_torch.ops import bn_act as tba
from unit_tpu_torch.ops import bn_act_cuda

# (has_residual, relu): conv3's epilogue; conv1, conv2 and the stem; the shortcut
FLAGS = [(True, True), (False, True), (False, False)]
# NCHW shapes: odd C (scalar path), odd rows, C a multiple of 8, N = 1 and H = W = 1
SHAPES = [(2, 4, 5, 7), (1, 7, 3, 3), (3, 16, 6, 5), (1, 24, 1, 1), (5, 8, 1, 1)]


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


def make_inputs(shape, seed, dtype=torch.float32, device="cpu"):
    """x, residual (channels_last NCHW), BN buffers -> f32 scale, shift."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape
    x = rng.randn(n, h, w, c).astype(np.float32)
    res = rng.randn(n, h, w, c).astype(np.float32)
    bn = dict(weight=rng.uniform(0.5, 1.5, c), bias=rng.randn(c) * 0.3,
              mean=rng.randn(c) * 0.3, var=rng.uniform(0.5, 2.0, c))
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    scale = bn["weight"] / np.sqrt(bn["var"] + np.float32(1e-5))
    shift = bn["bias"] - bn["mean"] * scale
    as_nchw = lambda a: torch.as_tensor(a, device=device).to(dtype).permute(0, 3, 1, 2)  # noqa: E731
    return (x, res, bn, as_nchw(x), as_nchw(res),
            torch.as_tensor(scale, device=device), torch.as_tensor(shift, device=device))


@pytest.mark.parametrize("has_res,relu", FLAGS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_unit_tpu_chain_f32(shape, has_res, relu):
    import jax
    import jax.numpy as jnp

    from unit_tpu.models.resnet import FrozenBN

    x, res, bn, tx, tres, scale, shift = make_inputs(shape, 1)
    params = {"params": {k: jnp.asarray(v) for k, v in bn.items()}}
    out = FrozenBN(features=shape[1]).apply(params, jnp.asarray(x))
    if has_res:
        out = out + jnp.asarray(res)
    if relu:
        out = jax.nn.relu(out)
    got = tba.bn_act(tx, scale, shift, tres if has_res else None, relu)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(out),
                               rtol=1e-6, atol=1e-6)
    # ep_kernel's expression (f32, one rounding)
    want = x * scale.numpy() + shift.numpy() + (res if has_res else 0.0)
    want = np.maximum(want, 0.0) if relu else want
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("has_res,relu", FLAGS)
def test_plain_gradient_matches_jax_grad(has_res, relu):
    import jax
    import jax.numpy as jnp

    from unit_tpu.models.resnet import FrozenBN

    shape = (2, 6, 5, 3)
    x, res, bn, tx, tres, scale, shift = make_inputs(shape, 2)
    cot = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    params = {"params": {k: jnp.asarray(v) for k, v in bn.items()}}

    def chain(xv, rv):
        out = FrozenBN(features=shape[1]).apply(params, xv)
        out = out + rv if has_res else out
        out = jax.nn.relu(out) if relu else out
        return jnp.sum(out * jnp.asarray(cot))

    wx, wr = jax.grad(chain, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(res))
    tx = tx.clone().requires_grad_(True)
    tres = tres.clone().requires_grad_(True)
    out = tba.bn_act(tx, scale, shift, tres if has_res else None, relu)
    (out.permute(0, 2, 3, 1) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(wx),
                               rtol=1e-6, atol=1e-6)
    if has_res:
        np.testing.assert_allclose(tres.grad.permute(0, 2, 3, 1).numpy(), np.asarray(wr),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert tres.grad is None


@pytest.mark.parametrize("has_res,relu", FLAGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_backward_formula_equals_autograd(shape, dtype, has_res, relu):
    """The kernel's backward, written as a plain function of the saved output."""
    _, _, _, tx, tres, scale, shift = make_inputs(shape, 4, dtype)
    g = torch.as_tensor(np.random.RandomState(5).randn(*tx.shape).astype(np.float32)).to(dtype)
    tx = tx.clone().requires_grad_(True)
    tres = tres.clone().requires_grad_(True)
    y = tba.bn_act_plain(tx, scale, shift, tres if has_res else None, relu)
    y.backward(g)
    dx, dres = tba.bn_act_backward_plain(g, y.detach(), scale, relu)
    assert torch.equal(dx, tx.grad)
    if has_res:
        assert torch.equal(dres, tres.grad)


def test_bf16_rounds_once():
    """In bf16 the result is the f32 expression rounded once (ep_kernel), not
    unit_tpu's chain of bf16 roundings: they differ on some elements by one
    bf16 ulp, and the single rounding is never further from the f32 value."""
    x, res, _, tx, tres, scale, shift = make_inputs((2, 16, 9, 11), 6, torch.bfloat16)
    got = tba.bn_act(tx, scale, shift, tres, True).float()
    exact = torch.relu(tx.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
                       + tres.float())
    assert torch.equal(got, exact.to(torch.bfloat16).float())
    s16, t16 = (v.to(torch.bfloat16).view(1, -1, 1, 1) for v in (scale, shift))
    chain = torch.relu(tx * s16 + t16 + tres).float()
    assert not torch.equal(chain, got)
    assert float((got - exact).abs().max()) <= float((chain - exact).abs().max())
    ulp = torch.maximum(got.abs(), chain.abs()) * 2.0 ** -7
    # three more roundings and bf16 scale/shift: a few ulps of the larger operand
    assert bool(((got - chain).abs() <= 4 * torch.maximum(ulp, tx.float().abs() * 2.0 ** -7)
                 + 1e-2).all())


def test_dispatch_on_cpu():
    _, _, _, tx, tres, scale, shift = make_inputs((1, 4, 3, 3), 7)
    assert torch.equal(tba.bn_act(tx, scale, shift, tres), tba.bn_act_plain(tx, scale, shift, tres))
    with pytest.raises(ValueError, match="CUDA"):
        tba.bn_act(tx, scale, shift, tres, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        tba.bn_act(tx, scale, shift, tres, impl="pallas")


def test_nhwc_dense_reads_strides_not_flags():
    t = torch.zeros(2, 8, 4, 6).contiguous(memory_format=torch.channels_last)
    assert bn_act_cuda.nhwc_dense(t)
    assert not bn_act_cuda.nhwc_dense(torch.zeros(2, 8, 4, 6))
    assert not bn_act_cuda.nhwc_dense(t[:, :, ::2])
    assert not bn_act_cuda.nhwc_dense(t[:, :4])
    # N = 1: an NCHW-contiguous tensor is not NHWC-dense, whatever the flag says
    assert not bn_act_cuda.nhwc_dense(torch.zeros(1, 8, 4, 6))
    # H = W = 1 and C = 1: both layouts address the same memory
    assert bn_act_cuda.nhwc_dense(torch.zeros(5, 8, 1, 1))
    assert bn_act_cuda.nhwc_dense(torch.zeros(5, 1, 4, 6))
    # a size-1 dimension's stride addresses nothing
    assert bn_act_cuda.nhwc_dense(torch.zeros(1, 4, 6, 8).permute(0, 3, 1, 2)[:1])


# --------------------------------------------------------------------------- #
# on the card
CUDA_SHAPES = SHAPES + [(2, 64, 25, 40), (1, 1024, 13, 21), (4, 130, 7, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("has_res,relu", FLAGS + [(True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernel_forward_and_backward_equal_plain(cuda_device, shape, dtype, has_res, relu):
    _, _, _, tx, tres, scale, shift = make_inputs(shape, 8, dtype, cuda_device)
    g = torch.as_tensor(np.random.RandomState(9).randn(*tx.shape).astype(np.float32),
                        device=cuda_device).to(dtype)
    outs = {}
    for impl in ("cuda", "plain"):
        xi = tx.clone().requires_grad_(True)
        ri = tres.clone().requires_grad_(True)
        fwd, bwd = (bn_act_cuda.bn_act_forward_cuda.launches,
                    bn_act_cuda.bn_act_backward_cuda.launches)
        y = tba.bn_act(xi, scale, shift, ri if has_res else None, relu, impl)
        y.backward(g)
        if impl == "cuda":
            assert bn_act_cuda.bn_act_forward_cuda.launches == fwd + 1
            # without relu and without dx there is nothing to launch; here dx is needed
            assert bn_act_cuda.bn_act_backward_cuda.launches == bwd + 1
            assert bn_act_cuda.nhwc_dense(y)
        outs[impl] = (y.detach(), xi.grad, ri.grad)
    torch.cuda.synchronize()
    for got, want in zip(outs["cuda"], outs["plain"]):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_converts_other_layouts_and_counts_it(cuda_device):
    _, _, _, tx, tres, scale, shift = make_inputs((1, 16, 6, 10), 10, torch.bfloat16, cuda_device)
    want = tba.bn_act_plain(tx, scale, shift, tres, True)
    before = bn_act_cuda.layout_copies
    assert torch.equal(tba.bn_act(tx, scale, shift, tres, True, "cuda"), want)
    assert bn_act_cuda.layout_copies == before
    nchw = tx.contiguous()  # N = 1: the channels_last flag alone would not tell
    assert not bn_act_cuda.nhwc_dense(nchw)
    assert torch.equal(tba.bn_act(nchw, scale, shift, tres, True, "cuda"), want)
    assert bn_act_cuda.layout_copies == before + 1
    # a sliced residual and an unaligned base pointer (scalar path)
    wide = torch.cat([tres, tres], dim=1)[:, 16:]
    assert torch.equal(tba.bn_act(tx, scale, shift, wide, True, "cuda"), want)
    assert bn_act_cuda.layout_copies == before + 2
    flat = torch.zeros(tx.numel() + 1, dtype=tx.dtype, device=cuda_device)
    odd = flat[1:].view(1, 6, 10, 16).permute(0, 3, 1, 2)
    odd.copy_(tx)
    assert odd.data_ptr() % 16 != 0 and bn_act_cuda.nhwc_dense(odd)
    assert torch.equal(tba.bn_act(odd, scale, shift, tres, True, "cuda"), want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    _, _, _, tx, tres, scale, shift = make_inputs((1, 8, 3, 3), 11, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tba.bn_act(tx.half(), scale, shift, None, True, "cuda")
    with pytest.raises(ValueError, match="float32"):
        tba.bn_act(tx, scale.double(), shift, None, True, "cuda")
    with pytest.raises(ValueError, match="match"):
        tba.bn_act(tx, scale, shift, tres[:, :4], True, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tba.bn_act(tx.cpu(), scale.cpu(), shift.cpu(), None, True, "cuda")
