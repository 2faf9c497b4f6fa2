"""Box geometry and anchors in unit_tpu_torch vs unit_tpu (atol 1e-5).

Inputs are box coordinates of at most a few hundred pixels, so 1e-5 is a few
f32 ulps: both sides evaluate the same expressions in f32, and only exp()
may differ by an ulp between the two libraries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_boxes import random_boxes
from unit_tpu.ops import anchors as janchors
from unit_tpu.structures import boxes as jboxes
from unit_tpu_torch.ops import anchors as tanchors
from unit_tpu_torch.structures import boxes as tboxes

ATOL = 1e-5


def both(fn_name, *arrays, **kw):
    want = getattr(jboxes, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(tboxes, fn_name)(*(torch.as_tensor(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(want)


def boxes_with_degenerate(rng, n):
    b = random_boxes(rng, n, size=300.0)
    b[::5, 2] = b[::5, 0]            # zero width
    b[1::7, 3] = b[1::7, 1] - 3.0    # negative height
    return b


@pytest.mark.parametrize("fn_name", ["pairwise_iou", "pairwise_intersection"])
def test_pairwise(rng, fn_name):
    got, want = both(fn_name, boxes_with_degenerate(rng, 23), boxes_with_degenerate(rng, 17))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_pairwise_iou_is_bit_identical(rng):
    """The NMS kernel's exactness rests on this op order."""
    got, want = both("pairwise_iou", random_boxes(rng, 64, 80.0), random_boxes(rng, 64, 80.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn_name", ["area", "nonempty"])
def test_unary(rng, fn_name):
    got, want = both(fn_name, boxes_with_degenerate(rng, 40))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_nonempty_threshold(rng):
    got, want = both("nonempty", boxes_with_degenerate(rng, 40), threshold=20.0)
    np.testing.assert_array_equal(got, want)


def test_clip_boxes(rng):
    b = random_boxes(rng, 30, size=400.0) - 50.0
    want = np.asarray(jboxes.clip_boxes(jnp.asarray(b), (217.0, 311.0)))
    got = tboxes.clip_boxes(torch.as_tensor(b), (torch.tensor(217.0), torch.tensor(311.0)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
@pytest.mark.parametrize("k", [1, 5])
def test_apply_deltas_with_scale_clamp(rng, weights, k):
    src = random_boxes(rng, 25, size=200.0)
    deltas = rng.randn(25, 4 * k).astype(np.float32)
    deltas[::3, 2::4] = 40.0   # far past log(1000/16): clamped
    deltas[1::3, 3::4] = 25.0
    got, want = both("apply_deltas", deltas, src, weights=weights)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)
    assert tboxes.SCALE_CLAMP == jboxes.SCALE_CLAMP


def test_cell_anchors():
    args = ((32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(tanchors.cell_anchors(*args), janchors.cell_anchors(*args))


@pytest.mark.parametrize("fh,fw", [(50, 84), (7, 3)])
def test_grid_anchors_yxa_order(fh, fw):
    sizes, ars = (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
    want = np.asarray(janchors.grid_anchors(fh, fw, 16, sizes, ars))
    got = tanchors.grid_anchors(fh, fw, 16, sizes, ars).numpy()
    assert got.shape == (fh * fw * 15, 4)
    np.testing.assert_array_equal(got, want)


def test_get_deltas(rng):
    """get_deltas vs unit_tpu, with degenerate boxes (sides floored at 1e-6),
    and apply_deltas inverting it on proper boxes."""
    src, tgt = boxes_with_degenerate(rng, 31), boxes_with_degenerate(rng, 31)
    w = (10.0, 10.0, 5.0, 5.0)
    got, want = both("get_deltas", src, tgt, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    src, tgt = random_boxes(rng, 19, size=300.0), random_boxes(rng, 19, size=300.0)
    d = tboxes.get_deltas(torch.as_tensor(src), torch.as_tensor(tgt), w)
    back = tboxes.apply_deltas(d, torch.as_tensor(src), w)
    np.testing.assert_allclose(back.numpy(), tgt, atol=1e-3)
