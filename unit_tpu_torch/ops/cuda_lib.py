"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``unit_tpu_torch/_build/`` (listed in ``.gitignore``) for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [extra flags] -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded.  ``build_library`` does the
hashing, the compile to a temporary name and the atomic rename for any host
or device compiler: the port's host loader (``data/native.py``) builds
``csrc/dataloader.cc`` with g++ through it.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Per-source extra flags.  NMS must not contract IoU arithmetic into FMAs:
# a keep decision flips when an IoU moves one ulp across the threshold.
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "nms_mask": ("-fmad=false",),
    "roi_align_fwd": (),
    "roi_align_bwd": (),
    # bn_act.cu writes its arithmetic with __fmul_rn / __fadd_rn, which nvcc
    # never contracts, so it needs no flag to equal its plain version.
    "bn_act": (),
}

# name -> (seconds spent in nvcc, 0.0 if the library was already built;
# nvcc's stderr, i.e. the -Xptxas=-v register/shared-memory report)
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
            "CUDA kernels are built from unit_tpu_torch/csrc at first use"
        )
    return found


def build_library(compiler: str, src: Path, flags: Sequence[str],
                  libs: Sequence[str] = ()) -> Tuple[Path, float, str]:
    """Compile ``src`` into ``_build/lib<stem>-<hash>.so`` unless that file
    exists: ``compiler *flags -o <tmp> src *libs``, then an atomic rename, so
    that processes building at once each write their own temporary file and
    none loads a half-written library.  Returns (path, seconds spent in the
    compiler, 0.0 if it was built already; the compiler's stderr).  Raises
    RuntimeError with the compiler's output if it fails."""
    key = src.read_bytes() + " ".join((*flags, *libs)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src), *libs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed for {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, time.perf_counter() - t0, proc.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib_path, secs, report = build_library(nvcc_path(), CSRC_DIR / f"{name}.cu",
                                           BASE_FLAGS + EXTRA_FLAGS[name])
    BUILD_LOG[name] = (secs, report)
    return ctypes.CDLL(str(lib_path))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(tensor) -> ctypes.c_void_p:
    """The current PyTorch stream on ``tensor``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
