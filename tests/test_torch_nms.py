"""Greedy NMS in unit_tpu_torch (K3's plain version, nms, batched_nms) vs unit_tpu.

Every comparison is exact (no tolerance anywhere in this file): the plain
version computes IoU in the op order of unit_tpu's pairwise_iou, so keep
masks, indices and valid slots must be bit-identical to unit_tpu's XLA NMS
and to its Pallas kernel (interpret mode).  With ``max_keep`` only the first
``max_keep`` keeps are consumed (unit_tpu ops/nms.py:69-81); the port reports
later rows as not kept.  The kernel's specification,
``nms_sorted_mask_survivor_plain`` (survivor buffer, tiles of 64, the
kernel's shortcuts and its division-free threshold test), is held to the
plain version and to unit_tpu the same way, and the batched calls to a loop
over images and to unit_tpu's ``vmap``.

The CUDA kernel test needs the card and is skipped elsewhere; like
test_torch_roi_align.py, this file imports jax only inside the tests that
compare with unit_tpu, so the kernel tests also run on the card (no jax).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from unit_tpu_torch.ops import nms as tnms
from unit_tpu_torch.ops import nms_cuda
from unit_tpu_torch.ops.nms_cuda import nms_sorted_mask_cuda
from unit_tpu_torch.structures import boxes as tboxes

# (n, size, thr): dense clusters, sparse, odd sizes
CASES = [(300, 40.0, 0.5), (256, 2000.0, 0.5), (130, 60.0, 0.7), (517, 80.0, 0.3)]


def random_boxes(rng, n, size):
    """The generator of tests/test_boxes.py:24 (imported there with jax)."""
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size * 0.5 + 1.0
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_box_generator_is_the_unit_tpu_one():
    from tests.test_boxes import random_boxes as reference

    a, b = np.random.RandomState(1), np.random.RandomState(1)
    np.testing.assert_array_equal(random_boxes(a, 33, 70.0), reference(b, 33, 70.0))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_nms():
    """unit_tpu's NMS module (XLA) and its Pallas keep-mask kernel."""
    from unit_tpu.ops import nms
    from unit_tpu.ops.nms_pallas import nms_sorted_mask_pallas

    return nms, nms_sorted_mask_pallas


def sorted_boxes(n, size, seed, degenerate=False):
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, n, size=size)
    if degenerate:
        boxes[::4, 2] = boxes[::4, 0]   # zero width
        boxes[1::6, 3] = boxes[1::6, 1]  # zero height
    scores = rng.rand(n).astype(np.float32)
    return boxes[np.argsort(-scores, kind="stable")]


@pytest.mark.parametrize("n,size,thr", CASES)
@pytest.mark.parametrize("degenerate", [False, True])
def test_plain_mask_matches_xla(jax_nms, n, size, thr, degenerate):
    import jax.numpy as jnp

    sb = sorted_boxes(n, size, n, degenerate)
    want = np.asarray(jax_nms[0].nms_sorted_mask(jnp.asarray(sb), thr, tile_size=128))
    got = tnms.nms_sorted_mask_plain(torch.as_tensor(sb), thr, tile_size=128).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,size,thr", CASES)
@pytest.mark.parametrize("max_keep", [7, 64])
def test_plain_mask_with_max_keep_matches_xla(jax_nms, n, size, thr, max_keep):
    import jax.numpy as jnp

    sb = sorted_boxes(n, size, n + 1)
    want = np.asarray(jax_nms[0].nms_sorted_mask(jnp.asarray(sb), thr, tile_size=128,
                                                 max_keep=max_keep))
    got = tnms.nms_sorted_mask_plain(torch.as_tensor(sb), thr, max_keep).numpy()
    first = np.flatnonzero(want)[:max_keep]
    np.testing.assert_array_equal(np.flatnonzero(got), first)


@pytest.mark.parametrize("n,size,thr", CASES[:3])
def test_plain_mask_matches_pallas_interpret(jax_nms, n, size, thr):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    sb = sorted_boxes(n, size, n + 2, degenerate=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_nms[1](jnp.asarray(sb), thr, tile_size=128))
    got = tnms.nms_sorted_mask_plain(torch.as_tensor(sb), thr).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,max_out", [(400, 50), (400, 400), (90, 200)])
def test_nms_indices_and_slots_match(jax_nms, n, max_out):
    """Indices AND padding slots agree (stable sorts on both sides)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(n + max_out)
    boxes = random_boxes(rng, n, size=150.0)
    scores = rng.rand(n).astype(np.float32)
    scores[::9] = scores[1::9][: len(scores[::9])]  # ties
    valid = rng.rand(n) > 0.2
    wi, wv = jax_nms[0].nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out,
                            valid=jnp.asarray(valid), tile_size=128)
    ti, tv = tnms.nms(torch.as_tensor(boxes), torch.as_tensor(scores), 0.5, max_out,
                      valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_batched_nms_matches(jax_nms):
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    p, c = 60, 6
    boxes = random_boxes(rng, p * c, size=120.0)
    scores = rng.rand(p * c).astype(np.float32)
    classes = np.tile(np.arange(c), p)
    valid = scores > 0.3
    wi, wv = jax_nms[0].batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(classes), 0.5, 50, valid=jnp.asarray(valid))
    ti, tv = tnms.batched_nms(torch.as_tensor(boxes), torch.as_tensor(scores),
                              torch.as_tensor(classes), 0.5, 50, valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_dispatch_on_cpu():
    sb = torch.as_tensor(sorted_boxes(20, 50.0, 0))
    assert torch.equal(tnms.nms_sorted_mask(sb, 0.5), tnms.nms_sorted_mask_plain(sb, 0.5))
    with pytest.raises(ValueError, match="CUDA"):
        tnms.nms_sorted_mask(sb, 0.5, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        tnms.nms_sorted_mask(sb, 0.5, impl="xla")


@pytest.mark.cuda
@pytest.mark.parametrize("n,size,thr", CASES + [(6000, 1500.0, 0.7)])
@pytest.mark.parametrize("max_keep", [None, 100])
def test_kernel_mask_matches_plain(cuda_device, n, size, thr, max_keep):
    sb = torch.as_tensor(sorted_boxes(n, size, n + 3, degenerate=True), device=cuda_device)
    before = nms_sorted_mask_cuda.launches
    got = tnms.nms_sorted_mask(sb, thr, max_keep)
    assert nms_sorted_mask_cuda.launches == before + 1
    want = tnms.nms_sorted_mask_plain(sb, thr, max_keep)
    assert torch.equal(got, want)


# ------------------------------------------------- the kernel's specification
def tied_boxes(n, size, seed, degenerate):
    """Score-sorted boxes with duplicates (score ties sort them together) and,
    if asked, zero-area rows."""
    sb = sorted_boxes(n, size, seed, degenerate)
    sb[5::11] = sb[4::11][: len(sb[5::11])]  # a duplicate right after its twin
    sb[60:70] = sb[10:20]                    # duplicates in a later tile
    return sb


@pytest.mark.parametrize("n,size,thr", CASES)
@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("cap", [1, 7, 64, "n", "n+5"])
def test_survivor_plain_matches_plain_and_xla(jax_nms, n, size, thr, degenerate, cap):
    """Exact: survivor-buffer form == tiled plain form == unit_tpu on the
    first max_keep keeps, with duplicates, zero-area rows, caps from 1 to
    above N, and N not a multiple of the tile (300, 130 and 517)."""
    import jax.numpy as jnp

    cap = {"n": n, "n+5": n + 5}.get(cap, cap)
    sb = tied_boxes(n, size, n + 7, degenerate)
    plain = tnms.nms_sorted_mask_plain(torch.as_tensor(sb), thr, cap)
    survivor = tnms.nms_sorted_mask_survivor_plain(torch.as_tensor(sb), thr, cap)
    assert torch.equal(survivor, plain)
    want = np.asarray(jax_nms[0].nms_sorted_mask(jnp.asarray(sb), thr, tile_size=128,
                                                 max_keep=cap))
    np.testing.assert_array_equal(np.flatnonzero(survivor.numpy()), np.flatnonzero(want)[:cap])


@pytest.mark.parametrize("tile", [1, 32, 64, 100])
@pytest.mark.parametrize("cap", [None, 20])
def test_survivor_plain_any_tile(tile, cap):
    sb = torch.as_tensor(tied_boxes(300, 40.0, 3, True))
    assert torch.equal(tnms.nms_sorted_mask_survivor_plain(sb, 0.5, cap, tile=tile),
                       tnms.nms_sorted_mask_plain(sb, 0.5, cap))


@pytest.mark.parametrize("n_valid", [0, 1, 63, 64, 65, 200, 300, 400])
def test_survivor_plain_n_valid(n_valid):
    """Rows from n_valid on are zeroed (as nms() hands them over): stopping
    the walk there changes nothing."""
    sb = torch.as_tensor(tied_boxes(300, 40.0, 4, False))
    sb[n_valid:] = 0.0
    got = tnms.nms_sorted_mask_survivor_plain(sb, 0.5, 50, n_valid=n_valid)
    assert torch.equal(got, tnms.nms_sorted_mask_plain(sb, 0.5, 50))
    assert not bool(got[n_valid:].any())


def test_survivor_plain_batched():
    """[B, N, 4] with per-image n_valid == the images one by one."""
    sb = torch.as_tensor(np.stack([tied_boxes(200, 40.0, s, s == 2) for s in (1, 2, 3)]))
    counts = torch.tensor([200, 90, 0], dtype=torch.int32)
    for i, c in enumerate(counts.tolist()):
        sb[i, c:] = 0.0
    got = tnms.nms_sorted_mask_survivor_plain(sb, 0.5, 30, n_valid=counts)
    assert got.shape == (3, 200)
    for i in range(3):
        assert torch.equal(got[i], tnms.nms_sorted_mask_plain(sb[i], 0.5, 30))
    assert torch.equal(tnms.nms_sorted_mask_plain(sb, 0.5, 30), got)
    assert tnms.nms_sorted_mask_plain(sb[:0], 0.5, 30).shape == (0, 200)


@st.composite
def box_sets(draw):
    """Random boxes on a coarse grid (touching and nested boxes, exact ties of
    the IoU with round thresholds) mixed with off-grid ones."""
    n = draw(st.integers(2, 90))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    grid = draw(st.sampled_from([4, 8, 1000]))
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, grid, (n, 2)).astype(np.float32)
    wh = rng.randint(0, grid // 2 + 1, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    jitter = rng.rand(n) < 0.3
    boxes[jitter] += rng.rand(int(jitter.sum()), 4).astype(np.float32) * 0.5
    return boxes


@settings(max_examples=120, deadline=None, database=None)
@given(boxes=box_sets(), thr=st.sampled_from([0.0, 0.3, 0.5, 0.7]),
       cap=st.sampled_from([None, 1, 5, 40]))
def test_kernel_shortcuts_never_change_a_mask(boxes, thr, cap):
    """The empty-intersection skip, the union-free bound and the
    division-free threshold test decide every pair as IoU > thr does."""
    sb = torch.as_tensor(boxes)
    area = tboxes.area(sb)
    assert torch.equal(tnms.kernel_pair_hits(sb, area, sb, area, thr),
                       tboxes.pairwise_iou(sb, sb) > thr)
    with_shortcuts = tnms.nms_sorted_mask_survivor_plain(sb, thr, cap, tile=16)
    without = tnms.nms_sorted_mask_survivor_plain(sb, thr, cap, tile=16,
                                                  kernel_arithmetic=False)
    assert torch.equal(with_shortcuts, without)
    assert torch.equal(with_shortcuts, tnms.nms_sorted_mask_plain(sb, thr, cap))


@pytest.mark.parametrize("thr", [0.0, 0.25, 1.0 / 3.0, 0.5, 0.75, 1.0, -0.1])
def test_division_free_threshold_on_exact_ties(thr):
    """Integer boxes give quotients that land exactly on round thresholds."""
    rng = np.random.RandomState(12)
    xy = rng.randint(0, 6, (400, 2)).astype(np.float32)
    sb = torch.as_tensor(np.concatenate([xy, xy + rng.randint(0, 5, (400, 2))], 1)
                         .astype(np.float32))
    area = tboxes.area(sb)
    want = tboxes.pairwise_iou(sb, sb) > thr
    assert torch.equal(tnms.kernel_pair_hits(sb, area, sb, area, thr), want)
    assert 0 < int(want.sum()) < want.numel() or thr in (1.0, -0.1)


# ----------------------------------------------------------- batched nms calls
def image_batch(b, n, seed):
    rng = np.random.RandomState(seed)
    boxes = np.stack([random_boxes(rng, n, size=150.0) for _ in range(b)])
    scores = rng.rand(b, n).astype(np.float32)
    twins = scores[:, 1::9]
    scores[:, 0:9 * twins.shape[1]:9] = twins  # ties
    valid = rng.rand(b, n) > np.linspace(0.1, 1.0, b)[:, None]  # the last image: none
    return boxes, scores, valid


@pytest.mark.parametrize("n,max_out", [(400, 50), (130, 130), (90, 200)])
def test_batched_nms_equals_loop_and_vmap(jax_nms, n, max_out):
    """nms([B, N]) == nms image by image == unit_tpu's vmapped nms: indices,
    padding slots and valid masks."""
    import jax
    import jax.numpy as jnp

    boxes, scores, valid = image_batch(3, n, n + max_out)
    ti, tv = tnms.nms(torch.as_tensor(boxes), torch.as_tensor(scores), 0.5, max_out,
                      valid=torch.as_tensor(valid))
    assert ti.shape == tv.shape == (3, min(n, max_out))
    for i in range(3):
        oi, ov = tnms.nms(torch.as_tensor(boxes[i]), torch.as_tensor(scores[i]), 0.5, max_out,
                          valid=torch.as_tensor(valid[i]))
        assert torch.equal(ti[i], oi) and torch.equal(tv[i], ov)
    wi, wv = jax.vmap(lambda b, s, v: jax_nms[0].nms(b, s, 0.5, max_out, valid=v,
                                                     tile_size=128))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    assert not bool(tv[2].any())


@pytest.mark.parametrize("with_valid", [True, False])
def test_batched_batched_nms_equals_loop_and_vmap(jax_nms, with_valid):
    """batched_nms([B, N]): each image gets its own class offset."""
    import jax
    import jax.numpy as jnp

    boxes, scores, valid = image_batch(3, 240, 17)
    boxes[1] *= 3.0  # another largest coordinate, so another offset
    classes = np.random.RandomState(3).randint(0, 6, (3, 240))
    tvalid = torch.as_tensor(valid) if with_valid else None
    ti, tv = tnms.batched_nms(torch.as_tensor(boxes), torch.as_tensor(scores),
                              torch.as_tensor(classes), 0.5, 40, valid=tvalid)
    for i in range(3):
        oi, ov = tnms.batched_nms(torch.as_tensor(boxes[i]), torch.as_tensor(scores[i]),
                                  torch.as_tensor(classes[i]), 0.5, 40,
                                  valid=tvalid[i] if with_valid else None)
        assert torch.equal(ti[i], oi) and torch.equal(tv[i], ov)
    wi, wv = jax.vmap(lambda b, s, c, v: jax_nms[0].batched_nms(
        b, s, c, 0.5, 40, valid=v if with_valid else None))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


# ------------------------------------------------------------ the wrapper's raises
def test_wrapper_raises_on_cpu():
    sb = torch.as_tensor(sorted_boxes(20, 50.0, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_sorted_mask_cuda(sb, 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_sorted_mask_cuda(sb[None], 0.5, 5)
    with pytest.raises(TypeError, match="float32"):
        nms_sorted_mask_cuda(sb.double(), 0.5)
    with pytest.raises(ValueError, match=r"\[N, 4\] or \[B, N, 4\]"):
        nms_sorted_mask_cuda(sb[:, :3], 0.5)


@pytest.mark.parametrize("max_keep", [None, 12000])
def test_wrapper_names_the_shared_memory_limit(max_keep):
    """More survivors than a block's shared memory holds: the message names
    the limit; a cap within it passes this check (and then wants the card)."""
    limit = nms_cuda.MAX_KEEP_LIMIT
    assert limit == 11520
    big = torch.zeros((limit + 480, 4))
    with pytest.raises(ValueError, match=f"at most {limit}"):
        nms_sorted_mask_cuda(big, 0.5, max_keep)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_sorted_mask_cuda(big, 0.5, limit)


# ------------------------------------------------ the kernel, on the card only
def train_layouts(n, images, seed):
    """The layouts of the RPN's training NMS at a small size: clustered,
    sparse (every row kept) and dense (few objects seen many times)."""
    rng = np.random.RandomState(seed)
    clustered = np.stack([sorted_boxes(n, 300.0, seed + i) for i in range(images)])
    xy = rng.rand(images, n, 2) * 2000.0
    sparse = np.concatenate([xy, xy + 8.0 + rng.rand(images, n, 2) * 30.0], 2)
    objects = random_boxes(rng, n // 8, size=600.0) * 2.0
    dense = objects[rng.randint(len(objects), size=(images, n))] + rng.rand(images, n, 4) * 0.5
    return {"clustered": clustered, "sparse": sparse.astype(np.float32),
            "dense": dense.astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["clustered", "sparse", "dense"])
@pytest.mark.parametrize("n,cap", [(12000, 2000), (1000, 150), (777, 1), (100, 105)])
def test_kernel_batch_is_one_launch_and_matches_plain(cuda_device, layout, n, cap):
    """4 images in one launch, bit-identical to the plain version and to a
    second launch; N not a multiple of 64, cap 1 and a cap above N."""
    sb = torch.as_tensor(train_layouts(n, 4, n + cap)[layout], device=cuda_device)
    before = (nms_sorted_mask_cuda.launches, nms_sorted_mask_cuda.images)
    got = tnms.nms_sorted_mask(sb, 0.7, cap)
    assert (nms_sorted_mask_cuda.launches, nms_sorted_mask_cuda.images) == \
        (before[0] + 1, before[1] + 4)
    assert torch.equal(got, tnms.nms_sorted_mask(sb, 0.7, cap))
    assert torch.equal(got, tnms.nms_sorted_mask_plain(sb, 0.7, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 0.3, 0.5, 0.7])
def test_kernel_matches_plain_on_exact_ties(cuda_device, thr):
    """Integer boxes: IoUs that land exactly on the threshold."""
    rng = np.random.RandomState(21)
    xy = rng.randint(0, 12, (3, 900, 2))
    sb = torch.as_tensor(np.concatenate([xy, xy + rng.randint(0, 7, (3, 900, 2))], 2)
                         .astype(np.float32), device=cuda_device)
    for cap in (None, 60):
        assert torch.equal(tnms.nms_sorted_mask(sb, thr, cap),
                           tnms.nms_sorted_mask_plain(sb, thr, cap))


@pytest.mark.cuda
def test_kernel_n_valid_in_one_batch(cuda_device):
    """Images of different valid counts in one launch, one with none: the
    mask with the hint, the mask without it, nms() and batched_nms()."""
    boxes, scores, valid = (torch.as_tensor(v, device=cuda_device)
                            for v in image_batch(3, 1000, 5))
    classes = torch.as_tensor(np.random.RandomState(6).randint(0, 20, (3, 1000)),
                              device=cuda_device)
    for fn, extra in ((tnms.nms, ()), (tnms.batched_nms, (classes,))):
        ki, kv = fn(boxes, scores, *extra, 0.5, 100, valid=valid, impl="cuda")
        pi, pv = fn(boxes, scores, *extra, 0.5, 100, valid=valid, impl="plain")
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
        assert not bool(kv[2].any())
    order = torch.argsort(-torch.where(valid, scores, -1e30), dim=1, stable=True)
    sv = torch.gather(valid, 1, order)
    sb = torch.where(sv[..., None], torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
                     0.0).contiguous()
    n_valid = sv.sum(1, dtype=torch.int32)
    want = tnms.nms_sorted_mask_plain(sb, 0.5, 100)
    assert torch.equal(nms_sorted_mask_cuda(sb, 0.5, 100, n_valid=n_valid), want)
    assert torch.equal(nms_sorted_mask_cuda(sb, 0.5, 100), want)
    assert nms_sorted_mask_cuda(sb[:0], 0.5, 100).shape == (0, 1000)


def tta_final_layout(rng, p=1000, c=20, variants=10):
    """The TTA evaluation's final NMS input: p proposals x c classes of
    decoded boxes (each class's box near its proposal's) and their scores,
    the probabilities SUMMED over the variants, so most pass 0.05."""
    xy = rng.uniform(0, 1, (p, 1, 2)) * [1000, 740]
    wh = rng.uniform(16, 400, (p, 1, 2))
    jitter = rng.normal(0, 6, (p, c, 4))
    boxes = (np.concatenate([xy, xy + wh], -1) + jitter).reshape(-1, 4)
    probs = sum(rng.dirichlet(np.ones(c + 1) * 0.3, p)[:, :c] for _ in range(variants))
    return boxes.astype(np.float32), probs.reshape(-1).astype(np.float32)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_tta_final_layout(cuda_device):
    """K3 at the TTA evaluation's final NMS: 20000 class-offset candidates,
    most of them valid, IoU 0.5, cap 100: the survivor buffer stops at the
    cap; masks bit-identical to the plain version, two launches alike."""
    boxes, probs = (torch.as_tensor(v, device=cuda_device)
                    for v in tta_final_layout(np.random.RandomState(12)))
    classes = torch.arange(20, device=cuda_device).repeat(1000)
    valid = probs > 0.05
    assert int(valid.sum()) > 15000
    ki, kv = tnms.batched_nms(boxes, probs, classes, 0.5, 100, valid=valid, impl="cuda")
    pi, pv = tnms.batched_nms(boxes, probs, classes, 0.5, 100, valid=valid, impl="plain")
    assert torch.equal(ki, pi) and torch.equal(kv, pv) and int(kv.sum()) == 100
    shifted = boxes + (classes.float() * (boxes.max() + 1.0))[:, None]
    order = torch.argsort(-torch.where(valid, probs, -1e30), stable=True)
    sb = torch.where(valid[order][:, None], shifted[order], 0.0).contiguous()
    n_valid = valid.sum(dtype=torch.int32)[None]
    before = nms_sorted_mask_cuda.launches
    got = nms_sorted_mask_cuda(sb, 0.5, 100, n_valid=n_valid)
    again = nms_sorted_mask_cuda(sb, 0.5, 100, n_valid=n_valid)
    assert nms_sorted_mask_cuda.launches == before + 2
    want = tnms.nms_sorted_mask_plain(sb, 0.5, 100)
    assert torch.equal(got, want) and torch.equal(got, again) and int(got.sum()) == 100


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_the_card(cuda_device):
    sb = torch.zeros((nms_cuda.MAX_KEEP_LIMIT + 1, 4), device=cuda_device)
    with pytest.raises(ValueError, match=f"at most {nms_cuda.MAX_KEEP_LIMIT}"):
        nms_sorted_mask_cuda(sb, 0.5)
    assert not bool(nms_sorted_mask_cuda(sb, 0.5, nms_cuda.MAX_KEEP_LIMIT).any())
    with pytest.raises(ValueError, match="n_valid"):
        nms_sorted_mask_cuda(sb[:64], 0.5, 10, n_valid=torch.zeros(1, device=cuda_device))
    with pytest.raises(ValueError, match="aligned"):
        nms_sorted_mask_cuda(torch.zeros(4 * 65 + 2, device=cuda_device)[2:].view(65, 4), 0.5)
