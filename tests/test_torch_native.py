"""The port's host loader (unit_tpu_torch/csrc/dataloader.cc through
unit_tpu_torch/data/native.py) against unit_tpu's (native/dataloader.cc
through unit_tpu/data/native.py), on the CPU.

unit_tpu's library is built here into a temporary directory with
native/Makefile's flags and loaded by patching unit_tpu.data.native's
``_LIB_PATHS``, so no test depends on native/libunit_native.so being there.
The first six tests are the twins of tests/test_native.py; the others hold
the port's C prep (file, in-memory and batch; flip on and off; a rounding
tie; a corrupt file and a PNG) equal to unit_tpu's bit for bit, the build
without libjpeg (PIL decodes, C resizes) equal to the build with it, and the
port's strong, classifier and test loaders and ``detect_bytes`` on JPEGs
equal to unit_tpu's with both packages on their C paths.  Tests skip only
where g++ or libjpeg is missing.
"""

import io
import os
import shutil
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest

import unit_tpu.data as jdata
import unit_tpu.data.native as jnative_mod
import unit_tpu_torch.data as tdata
from tests.test_torch_data import assert_same_batch, data_cfg, write_devkit
from tests.test_torch_serving import NAMES, pair, two_threads  # noqa: F401  (fixtures)
from tests.test_torch_slice import assert_same_detections
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.serving import DetectionService as JDetectionService
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data import native
from unit_tpu_torch.data.transforms import (
    TransformConfig, load_image_bgr, oriented_canvas, resize_image, resize_shortest_edge,
)
from unit_tpu_torch.serving import DetectionService

REPO = Path(__file__).resolve().parent.parent
# native/Makefile: $(CXX) $(CXXFLAGS) dataloader.cc -o $(TARGET) $(LDFLAGS)
MAKEFILE_CMD = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread")
VOC_SHAPES = [(500, 375), (375, 500), (333, 500)]  # (h, w) of VOC-sized images
CANVAS = (800, 1344)


def build_unit_tpu_native(out_dir) -> str:
    """unit_tpu's native/dataloader.cc built into ``out_dir`` as its Makefile
    builds it; skips the calling test where g++ or libjpeg is missing."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ here: the native loaders cannot be built")
    out = os.path.join(str(out_dir), "libunit_native.so")
    proc = subprocess.run([cxx, *MAKEFILE_CMD, str(REPO / "native" / "dataloader.cc"),
                           "-o", out, "-shared", "-ljpeg"], capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip(f"unit_tpu's native loader does not build here (libjpeg?): "
                    f"{proc.stderr[-300:]}")
    return out


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """unit_tpu.data.native on a library built for this module."""
    path = build_unit_tpu_native(tmp_path_factory.mktemp("unit_native"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative_mod, "_LIB_PATHS", [path])
    mp.setattr(jnative_mod, "_LIB", None)
    assert jnative_mod.available()
    yield jnative_mod
    mp.undo()


@pytest.fixture(scope="module")
def tnative():
    """The port's library, built with libjpeg."""
    if native.load_library() is None:
        pytest.skip(f"the port's loader does not build here: {native.STATUS['error']}")
    if native.STATUS["decode"] != "libjpeg":
        pytest.skip("no libjpeg here: the port's loader was built without its decoder")
    return native


def write_jpeg(path, h, w, seed, quality=90):
    from PIL import Image

    rgb = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(path, format="JPEG", quality=quality)
    return str(path)


@pytest.fixture(scope="module")
def jpeg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    return [write_jpeg(d / f"img{i}.jpg", h, w, i, quality=95)
            for i, (h, w) in enumerate([(120, 160), (90, 200), (300, 100)])]


@pytest.fixture(scope="module")
def voc_jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc_jpegs")
    return [write_jpeg(d / f"voc{i}.jpg", h, w, 10 + i) for i, (h, w) in enumerate(VOC_SHAPES)]


# --------------------------------------------------------------------------- #
# twins of tests/test_native.py


def test_prepare_batch_shapes_and_scale(tnative, jpeg_files):
    images, sizes, scales = native.prepare_batch_native(
        jpeg_files, min_size=96, max_size=160, canvas=(128, 192), n_threads=2)
    assert images.shape == (3, 128, 192, 3)
    for i, (h, w) in enumerate([(120, 160), (90, 200), (300, 100)]):
        scale = 96 / min(h, w)
        if max(h, w) * scale > 160:
            scale = 160 / max(h, w)
        assert abs(scales[i] - scale) < 1e-5
        assert abs(sizes[i, 0] - min(round(h * scale), 128)) <= 1
        assert abs(sizes[i, 1] - min(round(w * scale), 192)) <= 1


def test_native_matches_python_resize(tnative, jpeg_files):
    images, sizes, _ = native.prepare_batch_native(
        jpeg_files[:1], min_size=96, max_size=160, canvas=(128, 192), n_threads=1)
    bgr = load_image_bgr(jpeg_files[0])
    nh, nw, _ = resize_shortest_edge(bgr.shape[0], bgr.shape[1], 96, 160)
    want = resize_image(bgr, nh, nw)
    # the C resize works in f32, the numpy one in f64
    np.testing.assert_allclose(images[0, :nh, :nw], want, rtol=0, atol=2.0 ** -8)
    assert np.all(images[0, nh:] == 0)


def test_padding_region_zero(tnative, jpeg_files):
    images, sizes, _ = native.prepare_batch_native(
        jpeg_files, min_size=64, max_size=96, canvas=(128, 192), n_threads=3)
    for i in range(3):
        nh, nw = int(sizes[i, 0]), int(sizes[i, 1])
        assert np.all(images[i, nh:, :] == 0)
        assert np.all(images[i, :, nw:] == 0)
        assert images[i, :nh, :nw].max() > 0


def test_prepare_image_matches_python_flip(tnative, jpeg_files):
    path = jpeg_files[0]
    bgr = load_image_bgr(path)
    h, w = bgr.shape[:2]
    for flip in (False, True):
        img, (nh, nw), scale = native.prepare_image_native(path, 96, 160, (128, 192), flip=flip)
        eh, ew, escale = resize_shortest_edge(h, w, 96, 160)
        assert (nh, nw) == (min(eh, 128), min(ew, 192))
        assert abs(scale - escale) < 1e-6
        ref = resize_image(bgr, nh, nw)
        if flip:
            ref = ref[:, ::-1]
        np.testing.assert_allclose(img[:nh, :nw], ref, rtol=0, atol=2.0 ** -8)
        assert np.all(img[nh:] == 0) and np.all(img[:, nw:] == 0)


def test_stream_loader_uses_native_path(tnative, jpeg_files, monkeypatch):
    """A StreamLoader over JPEG records takes the C path and gives the batch
    the PIL path would, to the f32 resize's rounding."""
    from unit_tpu_torch.data.loader import StreamLoader, _native_eligible

    recs = []
    for i, p in enumerate(jpeg_files):
        h, w = load_image_bgr(p).shape[:2]
        recs.append({"image_id": f"im{i}", "file_name": p, "height": h, "width": w,
                     "annotations": [{"category_id": 1, "bbox": [5.0, 5.0, 40.0, 40.0]}]})
    assert _native_eligible(recs[0])
    tcfg = TransformConfig(min_sizes=(96,), max_size=160, canvas=(128, 192), max_gt=5,
                           num_classes=3)
    keys = ("image", "image_size", "gt_boxes", "gt_valid", "labels")
    calls = count_calls(monkeypatch, native, "prepare_image_native")
    batch = next(iter(StreamLoader(recs, tcfg, batch_size=2, keys=keys, seed=0)))
    assert calls["n"] >= 2
    assert batch["image"].shape[0] == 2 and batch["image"].dtype == np.float32
    assert batch["gt_valid"].any() and np.isfinite(batch["image"]).all()
    valid_boxes = batch["gt_boxes"][batch["gt_valid"]]
    assert (valid_boxes[:, 2] <= 192).all() and (valid_boxes >= 0).all()
    monkeypatch.setattr(native, "available", lambda: False)
    pil = next(iter(StreamLoader(recs, tcfg, batch_size=2, keys=keys, seed=0)))
    for k in keys[1:]:
        np.testing.assert_array_equal(batch[k], pil[k], err_msg=k)
    np.testing.assert_allclose(batch["image"], pil["image"], rtol=0, atol=2.0 ** -8)


def test_resize_rounding_matches_python_on_ties(tnative, tmp_path):
    """25x24 at min size 12 scales by exactly 0.5: 12.5 rounds to 12 (half to
    even, Python's round()), not 13."""
    from PIL import Image

    p = str(tmp_path / "tie.jpg")
    Image.fromarray(np.zeros((25, 24, 3), np.uint8)).save(p, quality=95)
    exp_h, exp_w, _ = resize_shortest_edge(25, 24, 12, 100)
    assert (exp_h, exp_w) == (12, 12)
    _, (nh, nw), _ = native.prepare_image_native(p, 12, 100, (32, 32))
    assert (nh, nw) == (exp_h, exp_w)


# --------------------------------------------------------------------------- #
# bit for bit against unit_tpu's library


def count_calls(monkeypatch, module, name):
    calls = {"n": 0}
    real = getattr(module, name)

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def assert_same_prep(got, want):
    assert len(got) == len(want)
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g == w


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape", VOC_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_prepare_image_equals_unit_tpu(tnative, jnative, voc_jpegs, shape, flip):
    path = voc_jpegs[VOC_SHAPES.index(shape)]
    canvas = oriented_canvas(*shape, CANVAS)
    got = native.prepare_image_native(path, 800, 1333, canvas, flip)
    assert_same_prep(got, jnative.prepare_image_native(path, 800, 1333, canvas, flip))
    data = Path(path).read_bytes()
    assert native.decode_image_size_mem_native(data) == \
        jnative.decode_image_size_mem_native(data) == shape
    mem = native.prepare_image_mem_native(data, 800, 1333, canvas, flip)
    assert_same_prep(mem, jnative.prepare_image_mem_native(data, 800, 1333, canvas, flip))
    assert_same_prep(mem[:3], got)  # from bytes as from the file
    assert mem[3] == shape


def test_prepare_batch_equals_unit_tpu(tnative, jnative, voc_jpegs):
    got = native.prepare_batch_native(voc_jpegs, 800, 1333, CANVAS, n_threads=3)
    want = jnative.prepare_batch_native(voc_jpegs, 800, 1333, CANVAS, n_threads=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for i, path in enumerate(voc_jpegs):  # a batch's canvas is one image's
        np.testing.assert_array_equal(
            got[0][i], native.prepare_image_native(path, 800, 1333, CANVAS)[0])


def test_rounding_tie_equals_unit_tpu(tnative, jnative, tmp_path):
    p = write_jpeg(tmp_path / "tie.jpg", 25, 24, 3)
    for flip in (False, True):
        got = native.prepare_image_native(p, 12, 100, (32, 32), flip)
        assert got[1] == (12, 12)
        assert_same_prep(got, jnative.prepare_image_native(p, 12, 100, (32, 32), flip))


def test_corrupt_file_and_png_fail_in_both(tnative, jnative, tmp_path, voc_jpegs):
    from PIL import Image

    corrupt = tmp_path / "corrupt.jpg"
    corrupt.write_bytes(Path(voc_jpegs[0]).read_bytes()[:200] + b"\x00" * 64)
    png = tmp_path / "png.jpg"  # PNG bytes under a JPEG name
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(png, format="PNG")
    for mod in (native, jnative):
        for path in (corrupt, png):
            with pytest.raises(RuntimeError):
                mod.prepare_image_native(str(path), 12, 100, (32, 32))
            with pytest.raises(RuntimeError):
                mod.prepare_batch_native([voc_jpegs[0], str(path)], 12, 100, (32, 32))
        with pytest.raises(RuntimeError):
            mod.decode_image_size_mem_native(png.read_bytes())
        with pytest.raises(RuntimeError):
            mod.prepare_image_mem_native(png.read_bytes(), 12, 100, (32, 32))


def test_the_build_without_libjpeg_equals_the_build_with_it(tnative, voc_jpegs, monkeypatch):
    """A host without jpeglib.h (the card's machine) builds the resize half
    alone: PIL decodes and ``prepare_rgb`` fills the canvas.  PIL's decode
    equals libjpeg's, so every entry point gives the same bits."""
    with_jpeg = {}
    for flip in (False, True):
        for path in voc_jpegs:
            canvas = oriented_canvas(*load_image_bgr(path).shape[:2], CANVAS)
            data = Path(path).read_bytes()
            with_jpeg[path, flip] = (native.prepare_image_native(path, 800, 1333, canvas, flip),
                                     native.prepare_image_mem_native(data, 800, 1333, canvas,
                                                                     flip))
    batch = native.prepare_batch_native(voc_jpegs, 800, 1333, CANVAS)
    lib, _, _ = native.build(libjpeg=False)
    assert not lib.has_libjpeg() and not hasattr(lib, "prepare_image")
    monkeypatch.setattr(native, "_LIB", lib)
    for (path, flip), (image, mem) in with_jpeg.items():
        canvas = oriented_canvas(*load_image_bgr(path).shape[:2], CANVAS)
        assert_same_prep(native.prepare_image_native(path, 800, 1333, canvas, flip), image)
        data = Path(path).read_bytes()
        assert_same_prep(native.prepare_image_mem_native(data, 800, 1333, canvas, flip), mem)
        assert native.decode_image_size_mem_native(data) == mem[3]
    for g, w in zip(native.prepare_batch_native(voc_jpegs, 800, 1333, CANVAS), batch):
        np.testing.assert_array_equal(g, w)
    png = io.BytesIO()
    from PIL import Image

    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(png, format="PNG")
    with pytest.raises(RuntimeError):
        native.prepare_image_mem_native(png.getvalue(), 12, 100, (32, 32))


# --------------------------------------------------------------------------- #
# the loaders and detect_bytes, both packages on their C paths


def write_jpeg_devkit(root):
    """tests/test_torch_data.py's devkit with a JPEG file for every image."""
    devkit = write_devkit(root, sizes=((375, 500), (500, 375), (333, 500)))
    for year in ("2007", "2012"):
        base = Path(devkit) / f"VOC{year}"
        for xml in sorted((base / "Annotations").glob("*.xml")):
            text = xml.read_text()
            w = int(text.split("<width>")[1].split("<")[0])
            h = int(text.split("<height>")[1].split("<")[0])
            write_jpeg(base / "JPEGImages" / f"{xml.stem}.jpg", h, w, zlib.crc32(xml.stem.encode()))
    return devkit


@pytest.fixture(scope="module")
def jpeg_devkit(tmp_path_factory):
    return write_jpeg_devkit(tmp_path_factory.mktemp("VOCdevkit_jpeg"))


@pytest.fixture
def c_paths(tnative, jnative, jpeg_devkit, monkeypatch):
    """(port cfg, unit_tpu cfg) on the JPEG devkit, and the calls each
    package makes to its C path."""
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    tcfg, jcfg = data_cfg(get_cfg, jpeg_devkit), data_cfg(jget_cfg, jpeg_devkit)
    tdata.RegisterVOC(tcfg, jpeg_devkit).register_all()
    jdata.RegisterVOC(jcfg, jpeg_devkit).register_all()
    calls = (count_calls(monkeypatch, native, "prepare_image_native"),
             count_calls(monkeypatch, jnative, "prepare_image_native"))
    return tcfg, jcfg, calls


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("build", ["build_strong_loader", "build_classifier_loader"])
def test_stream_loaders_equal_unit_tpus_on_the_c_path(c_paths, build, uint8):
    tcfg, jcfg, calls = c_paths
    tcfg.TPU.HOST_TRANSFER_UINT8 = jcfg.TPU.HOST_TRANSFER_UINT8 = uint8
    tit, jit = iter(getattr(tdata, build)(tcfg, seed=3)), iter(getattr(jdata, build)(jcfg, seed=3))
    for _ in range(4):
        got, want = next(tit), next(jit)
        assert_same_batch(got, want)
        assert got["image"].dtype == (np.uint8 if uint8 else np.float32)
    assert calls[0]["n"] == calls[1]["n"] >= 8


def test_test_loader_equals_unit_tpus_on_the_c_path(c_paths):
    tcfg, jcfg, calls = c_paths
    name = "voc_base_training_query_val"
    tl, tn = tdata.build_test_loader(tcfg, name)
    jl, jn = jdata.build_test_loader(jcfg, name)
    got, want = list(tl), list(jl)
    assert tn == jn == len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        assert_same_batch({k: v for k, v in g.items() if k != "image_id"},
                          {k: v for k, v in w.items() if k != "image_id"})
    assert calls[0]["n"] == calls[1]["n"] == 8


@pytest.fixture(scope="module")
def jservice(pair):  # noqa: F811  (pair is the fixture imported above)
    cfg, jmodel, params, _ = pair
    return JDetectionService(cfg, model=jmodel, params=params, class_names=NAMES)


def spy_prepared(monkeypatch, svc):
    """Record the canvases ``svc`` submits."""
    seen = []
    real = svc._detect_prepared

    def spy(image, *a):
        seen.append(np.array(image))
        return real(image, *a)

    monkeypatch.setattr(svc, "_detect_prepared", spy)
    return seen


@pytest.mark.parametrize("shape", [(50, 70), (72, 54)])  # both canvas orientations
def test_detect_bytes_jpeg_equals_unit_tpus_on_the_c_path(tnative, jnative, pair, jservice,
                                                          shape, monkeypatch):
    cfg, _, _, tmodel = pair
    buf = io.BytesIO()
    from PIL import Image

    Image.fromarray((np.random.RandomState(7).rand(*shape, 3) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    data = buf.getvalue()
    calls = (count_calls(monkeypatch, native, "prepare_image_mem_native"),
             count_calls(monkeypatch, jnative, "prepare_image_mem_native"))
    svc = DetectionService(cfg, tmodel, class_names=NAMES)
    got_canvas, want_canvas = spy_prepared(monkeypatch, svc), spy_prepared(monkeypatch, jservice)
    got = svc.detect_bytes(data)
    want = jservice.detect_bytes(data)
    assert calls[0]["n"] == calls[1]["n"] == 1
    np.testing.assert_array_equal(got_canvas[0], want_canvas[0])
    assert_same_detections(got, want)
    assert all(0 <= d["box"][0] <= d["box"][2] <= shape[1] for d in got)
