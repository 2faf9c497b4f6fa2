"""ROIAlignV2 in unit_tpu_torch (K1's plain version, dispatch, kernel) vs unit_tpu.

The plain version is held against unit_tpu's XLA ROIAlign and against its
Pallas kernel run in interpret mode, in f32 with atol 1e-4: the bound of
tests/test_roi_align_pallas.py, which covers f32 rounding of the
interpolation sums at unit-normal features.

The CUDA kernel test needs the card and is skipped elsewhere.  jax is
imported only by the tests that compare with unit_tpu, so on the card (which
has no jax) the kernel tests run with
``python -m pytest tests/test_torch_roi_align.py tests/test_torch_nms.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from unit_tpu_torch.ops import roi_align as ra
from unit_tpu_torch.ops.roi_align_cuda import roi_align_cuda

ATOL = 1e-4


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
    with pytest.raises(NotImplementedError, match="K2"):
        roi_align_cuda(feats.float().requires_grad_(), rois)
