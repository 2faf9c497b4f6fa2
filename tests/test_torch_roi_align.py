"""ROIAlignV2 in unit_tpu_torch (K1 and K2, their plain versions, the autograd
Function, dispatch) vs unit_tpu.

The plain versions are held against unit_tpu's XLA ROIAlign (the forward,
and jax.vjp of it for the backward) and against its Pallas kernels run in
interpret mode, in f32 with atol 1e-4: the bound of
tests/test_roi_align_pallas.py, which covers f32 rounding of the
interpolation sums at unit-normal features and gradients.

The CUDA kernel tests need the card and are skipped elsewhere.  jax is
imported only by the tests that compare with unit_tpu, so on the card (which
has no jax) the kernel tests run with
``python -m pytest tests/test_torch_roi_align.py tests/test_torch_nms.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from unit_tpu_torch.ops import roi_align as ra
from unit_tpu_torch.ops.roi_align_cuda import roi_align_backward_cuda, roi_align_cuda

ATOL = 1e-4
# The Function's backward vs autograd through roi_align_plain: the same f32
# terms summed in another order, at unit-normal features and cotangents.
GRAD_ATOL = 1e-5


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


def xla_roi_align(feats, rois, p):
    """unit_tpu's XLA ROIAlign image by image: [B,H,W,C], [B,N,4] -> numpy."""
    import jax.numpy as jnp

    from unit_tpu.ops.roi_align import roi_align_xla

    return np.stack([
        np.asarray(roi_align_xla(jnp.asarray(f), jnp.asarray(r), p, 1 / 16.0, 2))
        for f, r in zip(feats, rois)
    ])


def edge_rois(h, w, rng, n_random=12):
    """Random ROIs plus out-of-bounds, sub-bin and last-row/column ROIs."""
    hi, wi = h * 16.0, w * 16.0
    edge = [
        [0.0, 0.0, wi, hi],                   # whole map
        [wi - 40, hi - 40, wi, hi],           # touching the last row and column
        [wi - 8, hi - 8, wi, hi],             # the last cell only
        [-40.0, -30.0, 50.0, 60.0],           # partly outside
        [wi + 50, hi + 20, wi + 200, hi + 90],  # fully outside
        [20.0, 30.0, 21.0, 30.5],             # sub-bin
        [0.0, 0.0, 0.0, 0.0],                 # degenerate
    ]
    x1 = rng.uniform(-40, wi, n_random)
    y1 = rng.uniform(-40, hi, n_random)
    rand = np.stack([x1, y1, x1 + rng.uniform(0.5, 400, n_random),
                     y1 + rng.uniform(0.5, 300, n_random)], -1)
    return np.concatenate([np.asarray(edge), rand]).astype(np.float32)


@pytest.mark.parametrize("hw,c,p", [((12, 15), 8, 7), ((7, 9), 32, 14), ((1, 6), 4, 4)])
def test_plain_matches_xla(rng, hw, c, p):
    h, w = hw
    feats = rng.randn(2, h, w, c).astype(np.float32)
    rois = np.stack([edge_rois(h, w, rng) for _ in range(2)])
    want = xla_roi_align(feats, rois, p)
    got = ra.roi_align_batched(torch.as_tensor(feats), torch.as_tensor(rois), p, 1 / 16.0, 2)
    assert got.shape == (2, rois.shape[1], p, p, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_plain_matches_pallas_interpret(rng):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from unit_tpu.ops.roi_align_pallas import roi_align_pallas_batched

    feats = rng.randn(2, 10, 12, 128).astype(np.float32)
    rois = np.stack([edge_rois(10, 12, rng, n_random=3) for _ in range(2)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(roi_align_pallas_batched(
            jnp.asarray(feats), jnp.asarray(rois), 7, 1 / 16.0, 2))
    got = ra.roi_align_batched(torch.as_tensor(feats), torch.as_tensor(rois), 7, 1 / 16.0, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_bf16_features_keep_their_dtype(rng):
    """Pooled features keep the feature dtype; the f32 interpolation of the
    bf16 values matches XLA's f32 result to one bf16 rounding (2^-8 rel)."""
    feats = torch.as_tensor(rng.randn(1, 8, 10, 16).astype(np.float32)).to(torch.bfloat16)
    rois = torch.as_tensor(edge_rois(8, 10, rng)[None])
    got = ra.roi_align_batched(feats, rois, 7)
    assert got.dtype == torch.bfloat16
    want = xla_roi_align(feats.float().numpy(), rois.numpy(), 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


def test_chunking_does_not_change_the_result(rng):
    feats = torch.as_tensor(rng.randn(1, 6, 7, 4).astype(np.float32))
    rois = torch.as_tensor(edge_rois(6, 7, rng, n_random=60)[None])
    a = ra.roi_align_plain(feats, rois, 4, chunk_size=64)
    b = ra.roi_align_plain(feats, rois, 4, chunk_size=5)
    assert torch.equal(a, b)


def test_dispatch_on_cpu():
    feats = torch.zeros(1, 4, 4, 2)
    rois = torch.zeros(1, 3, 4)
    assert ra.roi_align_batched(feats, rois, impl="auto").shape == (1, 3, 14, 14, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ra.roi_align_batched(feats, rois, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(feats, rois)
    with pytest.raises(ValueError, match="unknown"):
        ra.roi_align_batched(feats, rois, impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, dtype):
    """Kernel vs plain version on the card: f32 within 2e-5 (FMA contraction
    and summation order), bf16 within that plus one bf16 ulp."""
    rng = np.random.RandomState(0)
    feats = torch.as_tensor(rng.randn(2, 13, 17, 64).astype(np.float32),
                            device=cuda_device).to(dtype)
    rois = torch.as_tensor(np.stack([edge_rois(13, 17, rng, 40) for _ in range(2)]),
                           device=cuda_device)
    before = roi_align_cuda.launches
    got = ra.roi_align_batched(feats, rois, 14, impl="auto").float()
    assert roi_align_cuda.launches == before + 1
    want = ra.roi_align_batched(feats, rois, 14, impl="plain").float()
    tol = 2e-5 + (torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
                  if dtype == torch.bfloat16 else 0.0)
    assert bool(((got - want).abs() <= tol).all())
    # with features that require grad the same call goes through K1 and K2
    before_bwd = roi_align_backward_cuda.launches
    f = feats.detach().requires_grad_()
    ra.roi_align_batched(f, rois, 14, impl="auto").float().sum().backward()
    assert roi_align_cuda.launches == before + 2
    assert roi_align_backward_cuda.launches == before_bwd + 1
    assert f.grad.dtype == dtype and f.grad.shape == f.shape


def xla_roi_align_vjp(feats, rois, p, g):
    """jax.vjp of unit_tpu's XLA ROIAlign, image by image -> numpy dF."""
    import jax
    import jax.numpy as jnp

    from unit_tpu.ops.roi_align import roi_align_xla

    out = []
    for f, r, gi in zip(feats, rois, g):
        _, vjp = jax.vjp(lambda x: roi_align_xla(x, jnp.asarray(r), p, 1 / 16.0, 2),
                         jnp.asarray(f))
        out.append(np.asarray(vjp(jnp.asarray(gi))[0]))
    return np.stack(out)


@pytest.mark.parametrize("hw,c,p", [((12, 15), 8, 7), ((7, 9), 32, 14), ((1, 6), 4, 4),
                                    ((5, 1), 6, 3)])
def test_backward_plain_matches_xla_vjp(rng, hw, c, p):
    """Edge ROIs (outside, last row and column, sub-bin, degenerate) and
    H = 1, W = 1 maps."""
    h, w = hw
    feats = rng.randn(2, h, w, c).astype(np.float32)
    rois = np.stack([edge_rois(h, w, rng) for _ in range(2)])
    g = rng.randn(2, rois.shape[1], p, p, c).astype(np.float32)
    want = xla_roi_align_vjp(feats, rois, p, g)
    got = ra.roi_align_backward_plain(torch.as_tensor(g), torch.as_tensor(rois),
                                      feats.shape, p, 1 / 16.0, 2)
    assert got.shape == feats.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_backward_plain_matches_pallas_interpret(rng):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from unit_tpu.ops.roi_align_pallas_bwd import roi_align_backward_pallas_batched

    shape = (2, 10, 16, 8)
    rois = np.stack([edge_rois(10, 16, rng, n_random=3) for _ in range(2)])
    g = rng.randn(2, rois.shape[1], 4, 4, 8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(roi_align_backward_pallas_batched(
            jnp.asarray(g), jnp.asarray(rois), 4, 1 / 16.0, 2, shape))
    got = ra.roi_align_backward_plain(torch.as_tensor(g), torch.as_tensor(rois), shape, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_matches_autograd_of_plain(rng, dtype):
    """RoIAlignV2Function (impl plain): the explicit scatter equals autograd
    through roi_align_plain in f32; the ROIs get no gradient; dF keeps the
    feature dtype, so in bf16 it is the f32 sum rounded once (2^-8 rel)."""
    feats = torch.as_tensor(rng.randn(2, 9, 11, 6).astype(np.float32)).to(dtype)
    rois = torch.as_tensor(np.stack([edge_rois(9, 11, rng) for _ in range(2)]))
    g = torch.as_tensor(rng.randn(2, rois.shape[1], 5, 5, 6).astype(np.float32)).to(dtype)
    f1 = feats.float().requires_grad_()
    (want,) = torch.autograd.grad(ra.roi_align_plain(f1, rois, 5), f1, g.float())
    f2 = feats.clone().requires_grad_()
    r2 = rois.clone().requires_grad_()
    out = ra.roi_align_batched(f2, r2, 5)
    assert out.grad_fn is not None and "RoIAlignV2Function" in type(out.grad_fn).__name__
    got, got_rois = torch.autograd.grad(out, (f2, r2), g, allow_unused=True)
    assert got_rois is None and got.dtype == dtype
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=GRAD_ATOL, rtol=rtol)
    assert torch.equal(out, ra.roi_align_plain(feats, rois, 5))


def test_backward_plain_chunking_and_no_rois(rng):
    g = torch.as_tensor(rng.randn(1, 30, 4, 4, 2).astype(np.float32))
    rois = torch.as_tensor(edge_rois(6, 7, rng, n_random=23)[None])
    a = ra.roi_align_backward_plain(g, rois, (1, 6, 7, 2), 4, chunk_size=64)
    b = ra.roi_align_backward_plain(g, rois, (1, 6, 7, 2), 4, chunk_size=4)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    empty = ra.roi_align_backward_plain(g[:, :0], rois[:, :0], (1, 6, 7, 2), 4)
    assert empty.shape == (1, 6, 7, 2) and not empty.any()
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_backward_cuda(g, rois, (1, 6, 7, 2), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 17, 64), (1, 1, 5, 8), (2, 7, 1, 6), (1, 9, 11, 130)])
def test_backward_kernel_matches_plain(cuda_device, dtype, shape):
    """K2 vs its plain version on the card.  Bound: |k - p| <= 2^-16 * S, S =
    the plain backward of |g| (the sum of the absolute terms: the two differ
    only in summation order and product rounding, a few f32 ulps of S), plus
    one bf16 ulp of the output for bf16.  Two launches are bit-identical."""
    rng = np.random.RandomState(1)
    b, h, w, c = shape
    rois = torch.as_tensor(np.stack([edge_rois(h, w, rng, 40) for _ in range(b)]),
                           device=cuda_device)
    g = torch.as_tensor(rng.randn(b, rois.shape[1], 7, 7, c).astype(np.float32),
                        device=cuda_device).to(dtype)
    before = roi_align_backward_cuda.launches
    got = roi_align_backward_cuda(g, rois, shape, 7)
    again = roi_align_backward_cuda(g, rois, shape, 7)
    assert roi_align_backward_cuda.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = ra.roi_align_backward_plain(g, rois, shape, 7).float()
    bound = ra.roi_align_backward_plain(g.float().abs(), rois, shape, 7) * 2.0 ** -16
    if dtype == torch.bfloat16:
        bound = bound + torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
    assert bool(((got.float() - want).abs() <= bound + 1e-30).all())
