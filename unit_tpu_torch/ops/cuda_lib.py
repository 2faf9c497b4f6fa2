"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``unit_tpu_torch/_build/`` (listed in ``.gitignore``) for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [extra flags] -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

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


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    src = CSRC_DIR / f"{name}.cu"
    flags = BASE_FLAGS + EXTRA_FLAGS[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib_path.exists():
        BUILD_LOG[name] = (0.0, "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr)
    return ctypes.CDLL(str(lib_path))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(tensor) -> ctypes.c_void_p:
    """The current PyTorch stream on ``tensor``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
