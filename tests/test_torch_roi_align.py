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
from unit_tpu_torch.ops import roi_align_cuda as rac
from unit_tpu_torch.ops.roi_align_cuda import (roi_align_backward_cuda, roi_align_cuda,
                                               roi_row_lists_cuda)

ATOL = 1e-4
# The Function's backward vs autograd through roi_align_plain: the same f32
# terms summed in another order, at unit-normal features and cotangents.
GRAD_ATOL = 1e-5
# K2 and the separable plain form vs roi_align_backward_plain: |a - b| <=
# K2_REL * S, S = the plain backward of |g| (the sum of the absolute terms:
# the two differ in summation order and product rounding, a few f32 ulps of S).
K2_REL = 2.0 ** -16


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


def piled_rois(h, w, rng, n):
    """ROIs as a train step lays them out: half jittered around two objects,
    a quarter flat against the bottom border (half of those also against the
    right border), the rest random."""
    hi, wi = h * 16.0, w * 16.0
    rois = edge_rois(h, w, rng, n)[-n:]
    objs = np.asarray([[0.1, 0.15, 0.4, 0.6], [0.5, 0.3, 0.9, 0.8]]) * [wi, hi, wi, hi]
    k = n // 2
    rois[:k] = objs[rng.randint(2, size=k)] + rng.randn(k, 4) * 6
    q = n // 4
    x1 = rng.uniform(0, wi, q)
    rois[k:k + q] = np.stack([x1, np.full(q, hi), x1 + rng.uniform(1, 60, q),
                              np.full(q, hi)], -1)
    rois[k:k + q // 2, 0] = wi
    rois[k:k + q // 2, 2] = wi
    return rois.astype(np.float32)


def outside_rois(h, w, n):
    """n ROIs wholly beyond one border of the map each."""
    hi, wi = h * 16.0, w * 16.0
    four = [[wi + 50, 10, wi + 90, 40], [-200, 10, -100, 40],
            [10, hi + 40, 40, hi + 90], [10, -300, 40, -120]]
    return np.asarray([four[i % 4] for i in range(n)], np.float32)


SEPARABLE_SHAPES = [((12, 15), 8, 7), ((7, 9), 32, 14), ((1, 6), 4, 4), ((5, 1), 6, 3),
                    ((1, 1), 2, 2)]


@pytest.mark.parametrize("layout", ["edge", "piled", "outside"])
@pytest.mark.parametrize("hw,c,p", SEPARABLE_SHAPES)
def test_backward_separable_matches_plain(rng, hw, c, p, layout):
    """The dense separable form (what K2 sums) equals the explicit scatter
    within K2_REL * S on edge ROIs (whole map, last cell, partly and fully
    outside, sub-bin, degenerate), piled ROIs and ROIs wholly outside, on H =
    1 and W = 1 maps too, and with another sampling ratio."""
    h, w = hw
    make = {"edge": lambda: edge_rois(h, w, rng), "piled": lambda: piled_rois(h, w, rng, 19),
            "outside": lambda: outside_rois(h, w, 19)}[layout]
    rois = torch.as_tensor(np.stack([make() for _ in range(2)]))
    g = torch.as_tensor(rng.randn(2, rois.shape[1], p, p, c).astype(np.float32))
    shape = (2, h, w, c)
    for s in (2, 3):
        want = ra.roi_align_backward_plain(g, rois, shape, p, 1 / 16.0, s)
        got = ra.roi_align_backward_separable(g, rois, shape, p, 1 / 16.0, s)
        s_abs = ra.roi_align_backward_plain(g.abs(), rois, shape, p, 1 / 16.0, s)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert bool(((got - want).abs() <= K2_REL * s_abs + 1e-30).all())
        if layout == "outside":
            assert not got.any() and not want.any()
        # chunks of ROIs change the order of the sum only
        chunked = ra.roi_align_backward_separable(g, rois, shape, p, 1 / 16.0, s, chunk_size=5)
        assert bool(((chunked - want).abs() <= K2_REL * s_abs + 1e-30).all())


def test_backward_separable_matches_xla_vjp(rng):
    """...and jax.vjp of unit_tpu's XLA ROIAlign, at ATOL (f32 rounding of the
    sums at unit-normal cotangents), bf16 keeping the dtype of g."""
    h, w, c, p = 12, 15, 8, 7
    feats = rng.randn(2, h, w, c).astype(np.float32)
    rois = np.stack([edge_rois(h, w, rng) for _ in range(2)])
    g = rng.randn(2, rois.shape[1], p, p, c).astype(np.float32)
    want = xla_roi_align_vjp(feats, rois, p, g)
    got = ra.roi_align_backward_separable(torch.as_tensor(g), torch.as_tensor(rois),
                                          feats.shape, p, 1 / 16.0, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    got16 = ra.roi_align_backward_separable(torch.as_tensor(g).to(torch.bfloat16),
                                            torch.as_tensor(rois), feats.shape, p)
    assert got16.dtype == torch.bfloat16


def test_axis_weights_sum_to_one_inside(rng):
    """Every bin whose samples lie inside the map spreads a total weight of 1
    along an axis; one whose samples are all outside spreads 0; a clamped
    sample puts its whole weight on the last index."""
    pos = torch.tensor([[0.25, 0.75, 1.25, 1.75],      # inside, two bins
                        [-3.0, -2.0, 4.2, 4.9],        # first bin outside, second clamped
                        [5.5, 6.5, 7.5, 8.5]])         # beyond the end (size 5)
    wgt = ra.roi_axis_weights(pos, 5, 2)
    assert wgt.shape == (3, 2, 5)
    np.testing.assert_allclose(wgt.sum(2).numpy(), [[1, 1], [0, 1], [0, 0]], atol=1e-6)
    np.testing.assert_allclose(wgt[1, 1].numpy(), [0, 0, 0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(wgt[0, 0].numpy(), [0.5, 0.5, 0, 0, 0], atol=1e-6)


@pytest.mark.parametrize("layout", ["edge", "piled", "outside"])
@pytest.mark.parametrize("hw,p", [((12, 15), 7), ((7, 9), 14), ((1, 6), 4), ((5, 1), 3)])
def test_row_support_covers_the_rows_a_roi_touches(rng, hw, p, layout):
    """The row support of every ROI holds each row on which the plain
    backward of an all-ones g is non-zero (g >= 0: no term cancels), and a
    ROI wholly beyond a border has none."""
    h, w = hw
    rois = {"edge": lambda: edge_rois(h, w, rng), "piled": lambda: piled_rois(h, w, rng, 24),
            "outside": lambda: outside_rois(h, w, 8)}[layout]()
    first, last = ra.roi_row_support(torch.as_tensor(rois), h, w, p)
    assert first.shape == last.shape == (len(rois),)
    ones = torch.ones(1, 1, p, p, 2)
    rows = torch.arange(h)
    for i, roi in enumerate(rois):
        df = ra.roi_align_backward_plain(ones, torch.as_tensor(roi)[None, None], (1, h, w, 2), p)
        touched = df[0].abs().sum((1, 2)) > 0
        inside = (rows >= first[i]) & (rows <= last[i])
        assert bool((inside | ~touched).all()), (roi, first[i], last[i], touched)
        if layout == "outside":
            assert first[i] > last[i] and not touched.any()


@pytest.mark.parametrize("hwp", [(9, 11, 5), (1, 6, 4), (5, 1, 3)])
@pytest.mark.parametrize("layout", ["edge", "piled", "outside"])
def test_row_lists_are_ordered_and_complete(rng, layout, hwp):
    """The per-row lists (plain version of K2's list kernel) hold exactly the
    ROIs whose support holds the row, in ROI order, padded with -1; their
    lengths sum to the supports' sizes."""
    h, w, p = hwp
    rois = torch.as_tensor(np.stack([
        {"edge": lambda: edge_rois(h, w, rng), "piled": lambda: piled_rois(h, w, rng, 19),
         "outside": lambda: outside_rois(h, w, 19)}[layout]() for _ in range(2)]))
    lists, lens = ra.roi_row_lists(rois, h, w, p)
    n = rois.shape[1]
    assert lists.shape == (2, h, n) and lens.shape == (2, h)
    assert lists.dtype == lens.dtype == torch.int32
    for b in range(2):
        first, last = ra.roi_row_support(rois[b], h, w, p)
        assert int(lens[b].sum()) == int((last - first + 1).clamp_min(0).sum())
        for y in range(h):
            want = [i for i in range(n) if first[i] <= y <= last[i]]
            assert lists[b, y, :lens[b, y]].tolist() == want  # ROI order
            assert bool((lists[b, y, lens[b, y]:] == -1).all())
    if layout == "outside":
        assert not lens.any()
    with pytest.raises(ValueError, match="CUDA"):
        roi_row_lists_cuda(rois, h, w, p)


def k2_cases():
    """(name, shape, N or None for the edge set, ROI layout, segment, P)."""
    edge = [("edge", shape, None, "edge", 128, 7)
            for shape in [(2, 13, 17, 64), (1, 1, 5, 8), (2, 7, 1, 6), (1, 9, 11, 130)]]
    return edge + [
        ("piled", (2, 13, 17, 64), 96, "piled", 128, 7),
        ("one_roi", (1, 9, 11, 8), 1, "edge", 128, 7),
        ("n_not_a_multiple_of_the_segment", (2, 13, 17, 64), 45, "edge", 8, 7),
        ("lists_longer_than_two_segments", (2, 13, 17, 64), 96, "piled", 8, 7),
        ("all_outside", (2, 13, 17, 64), 40, "outside", 8, 7),
        ("more_than_16_bins", (1, 9, 11, 8), 30, "piled", 8, 20),
    ]


def k2_rois(h, w, rng, n, layout):
    if layout == "piled":
        return piled_rois(h, w, rng, n)
    if layout == "outside":
        return outside_rois(h, w, n)
    return edge_rois(h, w, rng, 40) if n is None else edge_rois(h, w, rng, n)[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", k2_cases(), ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}")
def test_backward_kernel_matches_plain(cuda_device, dtype, case, monkeypatch):
    """K2 vs its plain version on the card.  Bound: |k - p| <= 2^-16 * S, S =
    the plain backward of |g| (the sum of the absolute terms: the two differ
    only in summation order and product rounding, a few f32 ulps of S), plus
    one bf16 ulp of the output for bf16.  Two launches are bit-identical.
    Cases: the edge ROIs on odd sizes and H = 1, W = 1 maps; piled ROIs; one
    ROI; N not a multiple of the segment; rows whose lists are longer than two
    segments (through the f32 scratch); every ROI outside (dF all zeros);
    more than 16 bins a side (the kernel's wider register file of sums)."""
    name, shape, n, layout, seg, p = case
    monkeypatch.setitem(rac.BWD_TUNING, "seg", seg)
    rng = np.random.RandomState(1)
    b, h, w, c = shape
    rois = torch.as_tensor(np.stack([k2_rois(h, w, rng, n, layout) for _ in range(b)]),
                           device=cuda_device)
    g = torch.as_tensor(rng.randn(b, rois.shape[1], p, p, c).astype(np.float32),
                        device=cuda_device).to(dtype)
    before = roi_align_backward_cuda.launches
    got = roi_align_backward_cuda(g, rois, shape, p)
    again = roi_align_backward_cuda(g, rois, shape, p)
    assert roi_align_backward_cuda.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = ra.roi_align_backward_plain(g, rois, shape, p).float()
    bound = ra.roi_align_backward_plain(g.float().abs(), rois, shape, p) * K2_REL
    if dtype == torch.bfloat16:
        bound = bound + torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
    assert bool(((got.float() - want).abs() <= bound + 1e-30).all())
    lens = ra.roi_row_lists(rois, h, w, p)[1]
    if name == "lists_longer_than_two_segments":
        assert int(lens.max()) > 2 * seg
        assert roi_align_backward_cuda.scratch_bytes["scratch"] == (96 // seg) * got.numel() * 4
    if name == "all_outside":
        assert not lens.any() and not got.any()
    # the slices per block do not change a sum
    for warps in (1, 3):
        monkeypatch.setitem(rac.BWD_TUNING, "warps", warps)
        assert torch.equal(roi_align_backward_cuda(g, rois, shape, p), got)
    if name == "more_than_16_bins":
        with pytest.raises(ValueError, match="at most 32"):
            roi_align_backward_cuda(g[:, :, :1, :1].expand(-1, -1, 33, 33, -1).contiguous(),
                                    rois, shape, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["edge", "piled", "outside"])
@pytest.mark.parametrize("hw,n", [((13, 17), 40), ((50, 84), 512), ((1, 5), 33), ((7, 1), 1)])
def test_list_kernel_matches_plain(cuda_device, hw, n, layout):
    """K2's list kernel equals its plain version exactly: the same ROIs in
    the same order on every row, the same lengths."""
    h, w = hw
    rng = np.random.RandomState(2)
    rois = torch.as_tensor(np.stack([k2_rois(h, w, rng, n, layout) for _ in range(2)]),
                           device=cuda_device)
    for p, s in ((14, 2), (7, 3)):
        got_lists, got_lens = roi_row_lists_cuda(rois, h, w, p, 1 / 16.0, s)
        want_lists, want_lens = ra.roi_row_lists(rois, h, w, p, 1 / 16.0, s)
        assert torch.equal(got_lens, want_lens)
        assert torch.equal(got_lists, want_lists)
