"""ROIAlignV2 in unit_tpu_torch (K1 and K2, their plain versions, the autograd
Function, dispatch) vs unit_tpu.

The plain versions are held against unit_tpu's XLA ROIAlign (the forward,
and jax.vjp of it for the backward) and against its Pallas kernels run in
interpret mode, in f32 with atol 1e-4: the bound of
tests/test_roi_align_pallas.py, which covers f32 rounding of the
interpolation sums at unit-normal features and gradients.

``roi_align_separable`` (the sums K1 forms, in PyTorch) is held to
``roi_align_plain`` within 2e-5 in f32, the bound the kernel itself is held
to on the card: the two add the same f32 terms in another order and fold 1/s
per axis, a few f32 ulps of values of order 1-5.

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


@pytest.mark.parametrize("p", [33, 64])
def test_backward_kernel_names_its_output_size_limit(p):
    """K2 keeps one bin a lane: output_size above 32 raises and names the
    limit (before anything else is looked at, so also here without a card);
    32 itself passes that check and then wants the card.  The plain version
    takes any size."""
    assert rac.MAX_BWD_OUTPUT_SIZE == 32
    g = torch.zeros(1, 2, p, p, 2)
    rois = torch.tensor([[[0.0, 0.0, 40.0, 40.0], [8.0, 8.0, 30.0, 20.0]]])
    with pytest.raises(ValueError, match=rf"output_size {p}.*at most 32"):
        roi_align_backward_cuda(g, rois, (1, 4, 4, 2), p)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_backward_cuda(torch.zeros(1, 2, 32, 32, 2), rois, (1, 4, 4, 2), 32)
    assert ra.roi_align_backward_plain(g, rois, (1, 4, 4, 2), p).shape == (1, 4, 4, 2)
    assert "32" in ra.RoIAlignV2Function.__doc__ and "32" in roi_align_backward_cuda.__doc__


def k1_cases():
    """(name, [B, H, W, C], ROIs an image or None for the edge set, ROI
    layout, P, s, elements the feature pointer is moved off its alignment)."""
    return [
        ("edge", (2, 13, 17, 64), None, "edge", 14, 2, 0),
        ("edge_h1", (1, 1, 5, 8), None, "edge", 7, 2, 0),
        ("edge_w1_pairs", (2, 7, 1, 6), None, "edge", 7, 2, 0),
        ("edge_c130_pairs", (1, 9, 11, 130), None, "edge", 7, 2, 0),
        ("piled", (2, 13, 17, 64), 96, "piled", 14, 2, 0),
        ("outside", (2, 13, 17, 64), 40, "outside", 14, 2, 0),
        ("one_roi", (1, 9, 11, 8), 1, "edge", 6, 2, 0),
        ("unaligned_pointer_pairs", (2, 13, 17, 64), 40, "piled", 14, 2, 2),
        ("partial_last_slice", (1, 9, 11, 1088), 24, "piled", 7, 2, 0),
        ("sampling_ratio_3", (2, 13, 17, 64), 40, "piled", 17, 3, 0),
        ("more_than_48_kb_of_sums", (1, 20, 200, 256), 30, "piled", 40, 2, 0),
        ("slice_halved_to_fit", (1, 6, 300, 256), 12, "piled", 80, 2, 0),
        # a fine-tune step's 8 images: 822 M output elements, 3.3 GB in f32,
        # beyond 32-bit byte offsets (the kernel's in-image offsets stay 32-bit)
        ("fine_tune_step_8_images", (8, 50, 84, 1024), 512, "piled", 14, 2, 0),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", k1_cases(), ids=lambda c: c[0])
def test_kernel_matches_plain(cuda_device, dtype, case, monkeypatch):
    """K1 vs its plain version on the card: f32 within 2e-5 (FMA contraction
    and summation order), bf16 within that plus one bf16 ulp; two launches
    bit-identical; the launch counter moves by one a call.  Cases: the edge
    ROIs on odd sizes and H = 1, W = 1 maps; C = 6 and 130 and a feature
    pointer off 16 bytes (the channel-pair path); piled ROIs; every ROI
    outside (all zeros); one ROI; a last slice narrower than the others;
    another sampling ratio; a P whose sums need more than 48 KB of shared
    memory, and one where the slice is halved to fit the card's limit; a
    fine-tune step's 8 images x 512 ROIs (an output beyond 2^31 bytes in
    f32).  The tunables do not change a bit of the result."""
    name, shape, n, layout, p, s, shift = case
    rng = np.random.RandomState(3)
    b, h, w, c = shape
    store = torch.empty(int(np.prod(shape)) + shift, dtype=dtype, device=cuda_device)
    feats = store[shift:].view(shape)
    feats.copy_(torch.as_tensor(rng.randn(*shape).astype(np.float32)))
    rois = torch.as_tensor(np.stack([k2_rois(h, w, rng, n, layout) for _ in range(b)]),
                           device=cuda_device)
    vec = rac.fwd_vector(c, dtype, feats.data_ptr())
    assert vec == (2 if "pairs" in name else 16 // feats.element_size())
    before = roi_align_cuda.launches
    got = roi_align_cuda(feats, rois, p, 1 / 16.0, s)
    again = roi_align_cuda(feats, rois, p, 1 / 16.0, s)
    assert roi_align_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == (b, rois.shape[1], p, p, c)
    assert torch.equal(got, again)
    want = ra.roi_align_plain(feats, rois, p, 1 / 16.0, s).float()
    tol = 2e-5 + (torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                  if dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - want).abs() <= tol).all())
    if layout == "outside":
        assert not got.any()
    channels = rac.fwd_slice(c, w, p, s)
    need = rac.fwd_smem_bytes(w, p, s, channels)
    assert need == rac._lib().roi_align_fwd_smem_bytes(w, p, s, channels)
    if name == "more_than_48_kb_of_sums":
        assert channels == 256 and need > 48 * 1024
    if name == "slice_halved_to_fit":
        assert channels == 128 and rac.fwd_smem_bytes(w, p, s, 256) > rac._SMEM_LIMIT
    for slice_, threads in ((64, 32), (128, 256), (1024, 96)):
        monkeypatch.setitem(rac.FWD_TUNING, "slice", slice_)
        monkeypatch.setitem(rac.FWD_TUNING, "threads", threads)
        assert torch.equal(roi_align_cuda(feats, rois, p, 1 / 16.0, s), got)


def mask_path_boxes(rng, n=100, valid=63, h=800, w=1344):
    """A served image's final detections as the mask path pools them: boxes
    inside the canvas in the first ``valid`` rows, the padded rows of the
    invalid detections all zero."""
    xy = rng.uniform(0, 1, (valid, 2)) * [w - 40, h - 40]
    wh = rng.uniform(8, 600, (valid, 2))
    boxes = np.zeros((n, 4), np.float32)
    boxes[:valid] = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
    return boxes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_mask_paths_boxes(cuda_device, dtype):
    """K1 at the mask path's input: a request's res4 map [1, 50, 84, 1024]
    and its 100 final boxes, padded rows of zeros among them, P = 14; the
    bounds of test_kernel_matches_plain.  A zero box pools the top-left
    corner cell as the plain version does."""
    rng = np.random.RandomState(9)
    feats = torch.as_tensor(rng.randn(1, 50, 84, 1024).astype(np.float32),
                            device=cuda_device).to(dtype)
    rois = torch.as_tensor(mask_path_boxes(rng)[None], device=cuda_device)
    before = roi_align_cuda.launches
    got = roi_align_cuda(feats, rois, 14, 1 / 16.0, 2)
    assert roi_align_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, 100, 14, 14, 1024)
    want = ra.roi_align_plain(feats, rois, 14, 1 / 16.0, 2).float()
    tol = 2e-5 + (torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                  if dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - want).abs() <= tol).all())
    assert bool(got[0, 63:].float().abs().amax(dim=(1, 2, 3)).gt(0).all())


def support_boxes(rng, n, m=224):
    """One GT box a support shot on the m x m meta canvas, every seventh the
    whole canvas (the support loader's box for a shot without one of its
    class), whose samples reach the [-1, H] edge of the 14 x 14 map."""
    wh = rng.uniform(0.1, 0.9, (n, 2)) * m
    xy = rng.uniform(0, 1, (n, 2)) * (m - wh)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[::7] = [0, 0, m, m]
    return boxes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shots", [75, 750])
def test_kernel_matches_plain_at_the_support_shapes(cuda_device, dtype, shots):
    """K1 at the meta recipe's support stream: [C*K, 14, 14, 1024] res4 maps
    of 224-pixel shots, one ROI each (a train step's 15 x 5 shots and an
    evaluation's 15 x 50), P = 14; the bounds of test_kernel_matches_plain,
    two launches bit-identical."""
    rng = np.random.RandomState(11)
    feats = torch.as_tensor(rng.randn(shots, 14, 14, 1024).astype(np.float32),
                            device=cuda_device).to(dtype)
    rois = torch.as_tensor(support_boxes(rng, shots)[:, None], device=cuda_device)
    before = roi_align_cuda.launches
    got = roi_align_cuda(feats, rois, 14, 1 / 16.0, 2)
    again = roi_align_cuda(feats, rois, 14, 1 / 16.0, 2)
    assert roi_align_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == (shots, 1, 14, 14, 1024)
    assert torch.equal(got, again)
    want = ra.roi_align_plain(feats, rois, 14, 1 / 16.0, 2).float()
    tol = 2e-5 + (torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                  if dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - want).abs() <= tol).all())


# The TTA evaluation's groups (TEST.AUG's scales at MAX_SIZE 2000 on a 600 x
# 800 image, canvases of divisibility 32): res4 map [h, w] of each scale's
# flip pair, and one portrait (the transposed canvas of the largest scale).
TTA_GROUPS = [(480, (30, 40)), (576, (36, 48)), (688, (44, 58)), (864, (54, 72)),
              (1200, (76, 100)), (1200, (100, 76))]


def tta_group_boxes(rng, min_size, hw, n=1000):
    """[2, n, 4]: the canonical image's proposals (its 800-pixel frame, the
    content 800 x 1067 or 1067 x 800) scaled into a variant of shortest edge
    ``min_size``, as predict_tta lays them out: the plain variant, then its
    flipped twin (x mirrored about the variant's true width)."""
    h_c, w_c = (800, 1067) if hw[1] >= hw[0] else (1067, 800)
    xy = rng.uniform(0, 1, (n, 2)) * [w_c - 16, h_c - 16]
    wh = rng.uniform(8, 500, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w_c, h_c])], 1) * (min_size / 800)
    w_var = round(w_c * min_size / 800)
    flipped = np.stack([w_var - boxes[:, 2], boxes[:, 1], w_var - boxes[:, 0], boxes[:, 3]], 1)
    return np.stack([boxes, flipped]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", TTA_GROUPS, ids=lambda g: f"{g[0]}_{g[1][0]}x{g[1][1]}")
def test_kernel_matches_plain_at_the_tta_groups(cuda_device, dtype, group):
    """K1 at a TTA group: [2, h, w, 1024] (a scale's flip pair) x 1000 ROIs an
    image, P = 14, the widest map 100 columns; the bounds of
    test_kernel_matches_plain, two launches bit-identical."""
    min_size, (h, w) = group
    rng = np.random.RandomState(min_size + h)
    feats = torch.as_tensor(rng.randn(2, h, w, 1024).astype(np.float32),
                            device=cuda_device).to(dtype)
    rois = torch.as_tensor(tta_group_boxes(rng, min_size, (h, w)), device=cuda_device)
    before = roi_align_cuda.launches
    got = roi_align_cuda(feats, rois, 14, 1 / 16.0, 2)
    again = roi_align_cuda(feats, rois, 14, 1 / 16.0, 2)
    assert roi_align_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == (2, 1000, 14, 14, 1024)
    assert torch.equal(got, again)
    want = ra.roi_align_plain(feats, rois, 14, 1 / 16.0, 2).float()
    tol = 2e-5 + (torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                  if dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - want).abs() <= tol).all())


# The note recipe (InceptionResNetV2 to block17: 1088 channels, P = 17): the
# block17 map of a 600 x 800 canvas (35 x 48: the stem's unpadded
# convolutions, not 38 x 50) and of the 608 x 1344 canvas a 480 x 640 image at
# the recipe's 600-pixel side lies in (36 x 82), landscape and portrait.
NOTE_MAPS = [(35, 48), (48, 35), (36, 82), (82, 36)]


def note_rois(rng, hw, n=300):
    """[2, n, 4]: a train step's ROIs on a block17 map ``hw`` (the canvas its
    16-pixel cells span): the edge set, then proposals in the canvas."""
    h, w = hw[0] * 16.0, hw[1] * 16.0
    out = []
    for _ in range(2):
        xy = rng.uniform(0, 1, (n, 2)) * [w - 16, h - 16]
        wh = rng.uniform(8, 500, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
        edge = edge_rois(*hw, rng, 0)
        boxes[:len(edge)] = edge
        out.append(boxes)
    return np.stack(out).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", NOTE_MAPS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_kernels_match_plain_at_the_note_shapes(cuda_device, dtype, hw):
    """K1 and K2 at a note train step's stream: [2, h, w, 1088] x 300 ROIs an
    image, P = 17 (K2's kP = 32 instantiation, 17 of a warp's lanes a bin
    row), f32 and bf16.  K1 within the bounds of test_kernel_matches_plain,
    K2 within those of test_backward_kernel_matches_plain; two launches of
    each bit-identical, one count a launch."""
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    shape = (2,) + hw + (1088,)
    feats = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=cuda_device).to(dtype)
    rois = torch.as_tensor(note_rois(rng, hw), device=cuda_device)
    before = roi_align_cuda.launches
    got = roi_align_cuda(feats, rois, 17, 1 / 16.0, 2)
    again = roi_align_cuda(feats, rois, 17, 1 / 16.0, 2)
    assert roi_align_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == (2, 300, 17, 17, 1088)
    assert torch.equal(got, again)
    want = ra.roi_align_plain(feats, rois, 17, 1 / 16.0, 2).float()
    tol = 2e-5 + (torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
                  if dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - want).abs() <= tol).all())
    del got, again, want, tol
    g = torch.as_tensor(rng.randn(2, 300, 17, 17, 1088).astype(np.float32),
                        device=cuda_device).to(dtype)
    before = roi_align_backward_cuda.launches
    got = roi_align_backward_cuda(g, rois, shape, 17)
    again = roi_align_backward_cuda(g, rois, shape, 17)
    assert roi_align_backward_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, again)
    want = ra.roi_align_backward_plain(g, rois, shape, 17).float()
    s_abs = ra.roi_align_backward_plain(g.float().abs(), rois, shape, 17)
    bound = s_abs * K2_REL
    if dtype == torch.bfloat16:
        bound = bound + torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7
    assert bool(((got.float() - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_pair_through_the_function(cuda_device, dtype):
    """With features that require grad the dispatch goes through
    RoIAlignV2Function: K1 forward, K2 backward, one launch each."""
    rng = np.random.RandomState(0)
    feats = torch.as_tensor(rng.randn(2, 13, 17, 64).astype(np.float32),
                            device=cuda_device).to(dtype)
    rois = torch.as_tensor(np.stack([edge_rois(13, 17, rng, 40) for _ in range(2)]),
                           device=cuda_device)
    before, before_bwd = roi_align_cuda.launches, roi_align_backward_cuda.launches
    got = ra.roi_align_batched(feats, rois, 14, impl="auto")
    assert roi_align_cuda.launches == before + 1
    f = feats.detach().requires_grad_()
    out = ra.roi_align_batched(f, rois, 14, impl="auto")
    assert torch.equal(out.detach(), got)
    out.float().sum().backward()
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


# K1 and roi_align_separable vs roi_align_plain in f32 (chip_smoke's K1_F32_ATOL).
K1_ATOL = 2e-5
FORWARD_SEPARABLE_SHAPES = [((12, 15), 8, 7), ((7, 9), 6, 14), ((1, 6), 8, 6), ((5, 1), 6, 17),
                            ((9, 11), 130, 7), ((6, 7), 8, 17), ((1, 1), 6, 6)]


def layout_rois(h, w, rng, layout, n=19):
    return {"edge": lambda: edge_rois(h, w, rng), "piled": lambda: piled_rois(h, w, rng, n),
            "outside": lambda: outside_rois(h, w, n)}[layout]()


@pytest.mark.parametrize("layout", ["edge", "piled", "outside"])
@pytest.mark.parametrize("hw,c,p", FORWARD_SEPARABLE_SHAPES)
def test_separable_matches_plain(rng, hw, c, p, layout):
    """The dense separable form (what K1 sums) equals the sample-by-sample
    gather within K1_ATOL on edge ROIs (whole map, last cell, partly and
    fully outside, sub-bin, degenerate), piled ROIs and ROIs wholly outside,
    on H = 1 and W = 1 maps, for P in {6, 7, 14, 17} and C in {6, 8, 130},
    with another sampling ratio, and whatever the ROI chunks."""
    h, w = hw
    feats = torch.as_tensor(rng.randn(2, h, w, c).astype(np.float32))
    rois = torch.as_tensor(np.stack([layout_rois(h, w, rng, layout) for _ in range(2)]))
    for s in (2, 3):
        want = ra.roi_align_plain(feats, rois, p, 1 / 16.0, s)
        got = ra.roi_align_separable(feats, rois, p, 1 / 16.0, s)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= K1_ATOL
        if layout == "outside":
            assert not got.any() and not want.any()
        chunked = ra.roi_align_separable(feats, rois, p, 1 / 16.0, s, chunk_size=5)
        assert float((chunked - want).abs().max()) <= K1_ATOL


@pytest.mark.parametrize("hw,c,p", [((12, 15), 8, 7), ((7, 9), 32, 14), ((1, 6), 4, 4)])
def test_separable_matches_xla(rng, hw, c, p):
    """...and unit_tpu's XLA ROIAlign at ATOL, on the inputs of
    test_plain_matches_xla; bf16 features keep their dtype and stay within
    one bf16 ulp of roi_align_plain on them."""
    h, w = hw
    feats = rng.randn(2, h, w, c).astype(np.float32)
    rois = np.stack([edge_rois(h, w, rng) for _ in range(2)])
    want = xla_roi_align(feats, rois, p)
    got = ra.roi_align_separable(torch.as_tensor(feats), torch.as_tensor(rois), p, 1 / 16.0, 2)
    assert got.shape == (2, rois.shape[1], p, p, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # in bf16 both plain versions round their f32 sums once: one bf16 ulp apart at most
    feats16 = torch.as_tensor(feats).to(torch.bfloat16)
    got16 = ra.roi_align_separable(feats16, torch.as_tensor(rois), p)
    want16 = ra.roi_align_plain(feats16, torch.as_tensor(rois), p).float()
    assert got16.dtype == torch.bfloat16
    ulp = torch.maximum(got16.float().abs(), want16.abs()) * 2.0 ** -7
    assert bool(((got16.float() - want16).abs() <= K1_ATOL + ulp).all())


def test_separable_matches_pallas_interpret(rng):
    """...and unit_tpu's Pallas kernel in interpret mode, at ATOL, on the
    inputs of test_plain_matches_pallas_interpret."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from unit_tpu.ops.roi_align_pallas import roi_align_pallas_batched

    feats = rng.randn(2, 10, 12, 128).astype(np.float32)
    rois = np.stack([edge_rois(10, 12, rng, n_random=3) for _ in range(2)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(roi_align_pallas_batched(
            jnp.asarray(feats), jnp.asarray(rois), 7, 1 / 16.0, 2))
    got = ra.roi_align_separable(torch.as_tensor(feats), torch.as_tensor(rois), 7, 1 / 16.0, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("coordinate", [0, 1, 2, 3])
@pytest.mark.parametrize("fn", ["roi_align_plain", "roi_align_separable"])
def test_a_nan_roi_stays_with_its_roi(rng, fn, coordinate):
    """A diverged step hands ROIAlign NaN boxes.  Neither plain version
    indexes with the NaN: ``_corners`` puts a NaN sample on index 0 with
    weight 1, as the kernels' fmaxf/fminf clamp does, so the rows of that ROI
    are finite (the first row or column, interpolated along the other axis)
    and both versions agree on them; every other ROI's rows are bit-equal to
    a run without the NaN."""
    h, w, p = 9, 11, 7
    feats = torch.as_tensor(rng.randn(1, h, w, 6).astype(np.float32))
    rois = torch.as_tensor(edge_rois(h, w, rng)[None])
    clean = getattr(ra, fn)(feats, rois, p)
    bad = rois.clone()
    victim = 9
    bad[0, victim, coordinate] = float("nan")
    got = getattr(ra, fn)(feats, bad, p)
    assert bool(torch.isfinite(got).all())
    others = [i for i in range(rois.shape[1]) if i != victim]
    assert torch.equal(got[0, others], clean[0, others])
    other_fn = "roi_align_separable" if fn == "roi_align_plain" else "roi_align_plain"
    twin = getattr(ra, other_fn)(feats, bad, p)
    assert float((got - twin).abs().max()) <= K1_ATOL
    # every sample of the NaN axis sits on index 0: the bins along it are equal
    axis = 2 if coordinate % 2 == 0 else 1  # x: the pw axis of [N, P, P, C]; y: ph
    first = got[0, victim].select(axis - 1, 0)
    for k in range(1, p):
        assert float((got[0, victim].select(axis - 1, k) - first).abs().max()) <= K1_ATOL


@pytest.mark.parametrize("c,dtype,offset,want", [
    (1024, torch.bfloat16, 0, 8), (1024, torch.float32, 0, 4),
    (1088, torch.bfloat16, 0, 8), (512, torch.float32, 16, 4),
    (8, torch.bfloat16, 0, 8), (8, torch.float32, 0, 4),
    (130, torch.bfloat16, 0, 2), (130, torch.float32, 0, 2),   # C off the vector
    (6, torch.float32, 0, 2), (12, torch.bfloat16, 0, 2), (12, torch.float32, 0, 4),
    (1024, torch.bfloat16, 4, 2), (1024, torch.bfloat16, 8, 2),  # pointer off 16 bytes
    (1024, torch.float32, 8, 2),
    (1024, torch.bfloat16, 2, 0), (1024, torch.float32, 4, 0),   # pointer off a pair
    (7, torch.float32, 0, 0), (1023, torch.bfloat16, 0, 0),      # odd C
])
def test_load_path_is_a_function_of_shape_and_alignment(c, dtype, offset, want):
    """``fwd_vector``: 16 bytes a thread where C and every pointer allow it,
    else channel pairs, else nothing (the wrapper raises); decided from (C,
    dtype, addresses) alone, here on made-up addresses without a card."""
    base = 0x7F0000000000
    assert rac.fwd_vector(c, dtype, base + offset) == want
    assert rac.fwd_vector(c, dtype, base + offset, base) == want
    assert rac.fwd_vector(c, dtype, base, base + offset) == want


@pytest.mark.parametrize("c,w,p,s,want", [
    (1024, 84, 14, 2, 256),     # the flagship: FWD_TUNING's slice
    (1088, 84, 14, 2, 256),
    (64, 84, 14, 2, 64),        # no wider than the channels there are
    (130, 11, 7, 2, 256),       # 130 > 128: the next power of two
    (6, 1, 7, 2, 8),
    (256, 200, 40, 2, 256),     # 160 columns x 256 channels: 164 KB, fits
    (256, 300, 80, 2, 128),     # 300 columns: halved to fit 227 KB
    (1024, 2000, 500, 2, 16),
])
def test_slice_fits_the_shared_memory(c, w, p, s, want, monkeypatch):
    """``fwd_slice``: the tuned slice, narrowed to the channels and halved
    until a block's sums fit the card's shared memory; a shape that does not
    fit at 8 channels raises and names the limit."""
    monkeypatch.setitem(rac.FWD_TUNING, "slice", 256)
    got = rac.fwd_slice(c, w, p, s)
    assert got == want and got % 8 == 0
    assert rac.fwd_smem_bytes(w, p, s, got) <= rac._SMEM_LIMIT
    if got > max(8, rac.FWD_MIN_SLICE) and got < 256 and got < c:
        assert rac.fwd_smem_bytes(w, p, s, 2 * got) > rac._SMEM_LIMIT
    with pytest.raises(ValueError, match="232448"):
        rac.fwd_slice(64, 20000, 5000, 2)
    assert rac.fwd_threads() == rac.FWD_TUNING["threads"]
    for threads in (0, 48, 512):
        monkeypatch.setitem(rac.FWD_TUNING, "threads", threads)
        with pytest.raises(ValueError, match="at most 256"):
            rac.fwd_threads()


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
