"""ctypes bindings for the port's host loader, ``csrc/dataloader.cc``.

JPEG decode, half-pixel bilinear resize, flip and BGR-float canvas fill in
C++, with the GIL released for the whole call (ctypes drops it around a
foreign call), one image from a file or from request bytes, or a batch on a
thread pool.  Port of unit_tpu/data/native.py: the stream and test loaders
(``data/loader.py``) and ``DetectionService.detect_bytes`` take this path for
JPEGs whenever the library builds, and PIL + numpy otherwise, as unit_tpu's
do.

The library is built at first use, never at import, with the host compiler
(``$CXX`` or g++) and the flags of unit_tpu's ``native/Makefile``:

    g++ -O3 -fPIC -std=c++17 -Wall -pthread -shared -o _build/libdataloader-<hash>.so \
        csrc/dataloader.cc -ljpeg

into ``unit_tpu_torch/_build/`` (``ops/cuda_lib.py::build_library``: a hash
of source and flags in the name, an atomic rename).  Where the host has no
``jpeglib.h`` it is built without the decoder and without ``-ljpeg``: PIL
decodes, and the resize and canvas fill still run in C (``prepare_rgb``),
with the same arithmetic.  ``STATUS`` says what was built, or why nothing
was; a failed build makes ``available()`` false.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import io
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.cuda_lib import CSRC_DIR, build_library

SOURCE = CSRC_DIR / "dataloader.cc"
# native/Makefile's CXXFLAGS and LDFLAGS: nothing that changes f32 arithmetic
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
NO_LIBJPEG_FLAGS = ("-DUNIT_LOADER_NO_LIBJPEG",)

# {"built": bool, "decode": "libjpeg" | "PIL", "seconds": compile s (0.0 if
# built before), "path": the library, "error": why a build failed}
STATUS: Dict[str, object] = {}

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_BUILD_LOCK = threading.Lock()

_F32 = ctypes.POINTER(ctypes.c_float)
_INT = ctypes.POINTER(ctypes.c_int)


def has_jpeglib(cxx: str) -> bool:
    """Whether ``cxx`` finds ``jpeglib.h`` (a syntax-only compile)."""
    probe = "#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
    proc = subprocess.run([cxx, "-x", "c++", "-fsyntax-only", "-"], input=probe,
                          capture_output=True, text=True)
    return proc.returncode == 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.has_libjpeg.restype = ctypes.c_int
    lib.has_libjpeg.argtypes = []
    lib.prepare_rgb.restype = ctypes.c_int
    lib.prepare_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32, _F32, _F32]
    if lib.has_libjpeg():
        lib.decode_image_size_mem.restype = ctypes.c_int
        lib.decode_image_size_mem.argtypes = [ctypes.c_char_p, ctypes.c_long, _INT, _INT]
        lib.prepare_image.restype = ctypes.c_int
        lib.prepare_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _F32, _F32, _F32]
        lib.prepare_image_mem.restype = ctypes.c_int
        lib.prepare_image_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _F32, _F32, _F32, _F32]
        lib.prepare_batch.restype = ctypes.c_int
        lib.prepare_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _F32, _F32, _F32, ctypes.c_int]
    return lib


def build(libjpeg: Optional[bool] = None) -> Tuple[ctypes.CDLL, float, str]:
    """Build (if needed) and load the library: with the libjpeg decoder where
    ``libjpeg`` is true, without it where false, and where None with it if
    the compiler finds ``jpeglib.h``.  Returns (library, compile seconds, 0.0
    if it was built already; its path); raises RuntimeError if it cannot."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no host C++ compiler (set $CXX or put g++ on PATH)")
    if libjpeg is None:
        libjpeg = has_jpeglib(cxx)
    flags = CXX_FLAGS if libjpeg else CXX_FLAGS + NO_LIBJPEG_FLAGS
    path, secs, _ = build_library(cxx, SOURCE, flags, ("-ljpeg",) if libjpeg else ())
    return _bind(ctypes.CDLL(str(path))), secs, str(path)


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None if it cannot be
    built (``STATUS["error"]`` says why).  Safe from several threads."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _BUILD_LOCK:
        if not _TRIED:
            try:
                _LIB, secs, path = build()
                STATUS.update(built=True, decode="libjpeg" if _LIB.has_libjpeg() else "PIL",
                              seconds=secs, path=path, error=None)
            except (RuntimeError, OSError) as e:
                STATUS.update(built=False, decode=None, seconds=None, path=None, error=str(e))
            _TRIED = True
    return _LIB


def available() -> bool:
    """Whether the loaders and the server take the C path for JPEGs."""
    return load_library() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def _pil_jpeg_rgb(fp) -> np.ndarray:
    """RGB uint8 [h, w, 3] of a JPEG decoded by PIL (the decode of a host
    without libjpeg); RuntimeError if it is not a decodable JPEG, as the C
    decoder fails, so that the caller's PIL fallback takes it."""
    from PIL import Image

    try:
        with Image.open(fp) as im:
            if im.format != "JPEG":
                raise RuntimeError(f"not a JPEG ({im.format})")
            return np.ascontiguousarray(np.asarray(im.convert("RGB"), np.uint8))
    except (OSError, ValueError, SyntaxError) as e:
        raise RuntimeError(f"PIL could not decode the JPEG: {e}") from e


def _fill(lib, rgb: np.ndarray, min_size: int, max_size: int, canvas: Tuple[int, int],
          flip: bool, image: np.ndarray, size: np.ndarray, scale: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    lib.prepare_rgb(rgb.ctypes.data, h, w, min_size, max_size, canvas[0], canvas[1],
                    int(flip), _ptr(image), _ptr(size), _ptr(scale))


def _outputs(canvas: Tuple[int, int]):
    ch, cw = canvas
    return (np.zeros((ch, cw, 3), np.float32), np.zeros((2,), np.float32),
            np.zeros((1,), np.float32))


def prepare_image_native(path: str, min_size: int, max_size: int,
                         canvas: Tuple[int, int], flip: bool = False):
    """Decode, resize (and flip) one JPEG file into its canvas in C.

    Returns (image [H, W, 3] BGR float32, (new_h, new_w), scale); raises
    RuntimeError if the file does not decode (the caller falls back to
    PIL + numpy)."""
    lib = load_library()
    assert lib is not None, STATUS.get("error")
    image, size, scale = _outputs(canvas)
    if lib.has_libjpeg():
        if lib.prepare_image(path.encode(), min_size, max_size, canvas[0], canvas[1],
                             int(flip), _ptr(image), _ptr(size), _ptr(scale)):
            raise RuntimeError(f"native decode failed for {path}")
    else:
        _fill(lib, _pil_jpeg_rgb(path), min_size, max_size, canvas, flip, image, size, scale)
    return image, (int(size[0]), int(size[1])), float(scale[0])


def decode_image_size_mem_native(data: bytes) -> Tuple[int, int]:
    """(h, w) of an in-memory JPEG from its header alone; RuntimeError if it
    is not a JPEG header (the caller falls back to PIL)."""
    lib = load_library()
    assert lib is not None, STATUS.get("error")
    if not lib.has_libjpeg():
        from PIL import Image

        try:
            with Image.open(io.BytesIO(data)) as im:
                if im.format != "JPEG":
                    raise RuntimeError(f"not a JPEG ({im.format})")
                return int(im.size[1]), int(im.size[0])
        except (OSError, ValueError, SyntaxError) as e:
            raise RuntimeError(f"not a decodable JPEG header: {e}") from e
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.decode_image_size_mem(data, len(data), ctypes.byref(h), ctypes.byref(w)):
        raise RuntimeError("not a decodable JPEG header")
    return int(h.value), int(w.value)


def prepare_image_mem_native(data: bytes, min_size: int, max_size: int,
                             canvas: Tuple[int, int], flip: bool = False):
    """``prepare_image_native`` on a request's bytes (they never touch disk).

    Returns (image [H, W, 3] BGR float32, (new_h, new_w), scale, (orig_h,
    orig_w)); raises RuntimeError if the bytes do not decode (the caller
    falls back to PIL, e.g. for a PNG)."""
    lib = load_library()
    assert lib is not None, STATUS.get("error")
    image, size, scale = _outputs(canvas)
    if lib.has_libjpeg():
        orig = np.zeros((2,), np.float32)
        if lib.prepare_image_mem(data, len(data), min_size, max_size, canvas[0], canvas[1],
                                 int(flip), _ptr(image), _ptr(size), _ptr(scale), _ptr(orig)):
            raise RuntimeError("native in-memory decode failed")
        h, w = int(orig[0]), int(orig[1])
    else:
        rgb = _pil_jpeg_rgb(io.BytesIO(data))
        _fill(lib, rgb, min_size, max_size, canvas, flip, image, size, scale)
        h, w = rgb.shape[:2]
    return image, (int(size[0]), int(size[1])), float(scale[0]), (h, w)


def prepare_batch_native(paths: List[str], min_size: int, max_size: int,
                         canvas: Tuple[int, int], n_threads: int = 8):
    """Decode and resize a batch of JPEGs into one canvas shape on
    ``n_threads`` threads (C's own pool with libjpeg; without it, PIL's
    decode and the C fill, each of which releases the GIL, on a Python pool).

    Returns (images [N, H, W, 3], sizes [N, 2], scales [N]); raises
    RuntimeError if any file fails to decode."""
    lib = load_library()
    assert lib is not None, STATUS.get("error")
    n = len(paths)
    ch, cw = canvas
    images = np.zeros((n, ch, cw, 3), np.float32)
    sizes = np.zeros((n, 2), np.float32)
    scales = np.zeros((n,), np.float32)
    if lib.has_libjpeg():
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        errs = lib.prepare_batch(arr, n, min_size, max_size, ch, cw, _ptr(images),
                                 _ptr(sizes), _ptr(scales), n_threads)
    else:
        def one(i):
            try:
                rgb = _pil_jpeg_rgb(paths[i])
            except RuntimeError:
                sizes[i] = 0
                scales[i] = 1.0
                return 1
            _fill(lib, rgb, min_size, max_size, canvas, False, images[i], sizes[i],
                  scales[i:i + 1])
            return 0

        with concurrent.futures.ThreadPoolExecutor(max(1, min(n_threads, n))) as pool:
            errs = sum(pool.map(one, range(n)))
    if errs:
        raise RuntimeError(f"native batch decode failed for {errs}/{n} images")
    return images, sizes, scales
