"""Greedy NMS in unit_tpu_torch (K3's plain version, nms, batched_nms) vs unit_tpu.

Every comparison is exact: the plain version computes IoU in the op order
of unit_tpu's pairwise_iou, so keep masks, indices and valid slots must be
bit-identical to unit_tpu's XLA NMS and to its Pallas kernel (interpret
mode).  With ``max_keep`` only the first ``max_keep`` keeps are consumed
(unit_tpu ops/nms.py:69-81); the port reports later rows as not kept.

The CUDA kernel test needs the card and is skipped elsewhere; like
test_torch_roi_align.py, this file imports jax only inside the tests that
compare with unit_tpu, so the kernel tests also run on the card (no jax).
"""

import numpy as np
import pytest
import torch

from unit_tpu_torch.ops import nms as tnms
from unit_tpu_torch.ops.nms_cuda import nms_sorted_mask_cuda

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
