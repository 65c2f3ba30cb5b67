"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` exposes plain C entry points.  At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/qex_tpu_torch/`` at the repository root (named by
a hash of source and flags, so an edited source rebuilds) and bound with
``ctypes``.  Building needs a CUDA toolkit; nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "qex_tpu_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "ptxas": compiler report}; filled only
# by a build in this process
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need a CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _target(source: str) -> tuple[Path, Path]:
    """(source path, shared library path named by its content hash)."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build(sources: list[str]) -> None:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; raises if any build fails."""
    jobs = []
    for source in sources:
        src, so = _target(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((source, src, so, tmp, proc, time.perf_counter()))
    failed = []
    for source, src, so, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, so)
        BUILD_LOG[source] = {"seconds": time.perf_counter() - t0,
                             "ptxas": stderr.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<source>``."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    build([source])
    lib = ctypes.CDLL(str(_target(source)[1]))
    _LIBS[source] = lib
    return lib
