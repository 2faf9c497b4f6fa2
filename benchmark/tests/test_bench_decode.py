"""The reference's decode and resize of a request gives the same bits as the
program's C loader (csrc/dataloader.cc through data/native.py), on both
orientations, flipped and not, from PIL's decode as the C fill gets it on a
host without libjpeg and, where this host has libjpeg, from its own."""

import numpy as np
import pytest

import bench_testlib  # noqa: F401  (import paths)
import ref_decode
from harness import devkit


@pytest.mark.parametrize("shape", [(375, 500), (500, 375), (333, 500)])
@pytest.mark.parametrize("flip", [False, True])
def test_resize_matches_the_c_loader(shape, flip):
    from unit_tpu_torch.data import native

    lib = native.load_library()
    if lib is None:
        pytest.skip(f"the C loader does not build here: {native.STATUS['error']}")
    data = devkit.jpeg_bytes(devkit.natural_image(np.random.RandomState(sum(shape)), *shape))
    rgb = ref_decode.decode_rgb(data)
    canvas = (800, 1344) if shape[0] <= shape[1] else (1344, 800)
    want, (nh, nw), scale = ref_decode.resize_to_canvas(rgb, 800, 1333, canvas, flip)
    image, size, sc = native._outputs(canvas)
    native._fill(lib, rgb, 800, 1333, canvas, flip, image, size, sc)
    assert (nh, nw) == (int(size[0]), int(size[1])) and np.float32(scale) == sc[0]
    assert np.array_equal(want, image)
    if lib.has_libjpeg() and not flip:
        got, dims, s2, orig = native.prepare_image_mem_native(data, 800, 1333, canvas)
        assert orig == shape and dims == (nh, nw) and np.array_equal(got, want)
