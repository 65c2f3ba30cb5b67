"""ctypes binding of the host DML-checksum codec (port of
``qex_tpu.io.native``).

``native/dml_crc.cpp`` (a copy of the JAX package's codec) is compiled
with ``g++`` at first use into ``build/qex_tpu_torch/`` at the
repository root, named by a hash of source and flags, and never into the
package directory.  Where no compiler is present the checksums come from
the per-site ``zlib.crc32`` loop instead: the same numbers, about 40x
slower.  Every call records which of the two ran in :data:`last_route`
(``"native"`` or ``"zlib"``), and :func:`zlib_only` forces the loop, so
that a timing never passes one route off as the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "dml_crc.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "qex_tpu_torch")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
_forced_zlib = False
# "native" or "zlib": the route of the last checksum computed
last_route: str | None = None


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdmlcrc-{digest[:16]}.so"


def library():
    """The loaded codec, built on first use; None where it cannot be
    built (no ``g++``) or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _target()
        try:
            if not so.exists():
                cxx = shutil.which("g++")
                if cxx is None:
                    return None
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.dml_checksum.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32)]
            lib.site_crc32.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32)]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


@contextlib.contextmanager
def zlib_only():
    """Compute every checksum inside with the per-site zlib loop."""
    global _forced_zlib
    old, _forced_zlib = _forced_zlib, True
    try:
        yield
    finally:
        _forced_zlib = old


def _codec():
    global last_route
    lib = None if _forced_zlib else library()
    last_route = "zlib" if lib is None else "native"
    return lib


def site_crc32(site_bytes: np.ndarray) -> np.ndarray:
    """Per-site crc32 of (n, bytes_per_site) uint8 rows."""
    data = np.ascontiguousarray(site_bytes, dtype=np.uint8)
    lib = _codec()
    if lib is None:
        return np.fromiter((zlib.crc32(row) for row in data), np.uint32,
                           count=data.shape[0])
    out = np.empty(data.shape[0], np.uint32)
    lib.site_crc32(data.ctypes.data_as(ctypes.c_void_p),
                   ctypes.c_uint64(data.shape[0]),
                   ctypes.c_uint64(data.shape[1]),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def _rotl32(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    k = (k % 32).astype(np.uint32)
    return ((x << k) | (x >> (np.uint32(32) - k))) & np.uint32(0xFFFFFFFF)


def partial_checksum(site_bytes: np.ndarray, ranks: np.ndarray
                     ) -> tuple[int, int]:
    """(suma, sumb) over sites with explicit global lexicographic ranks:
    suma ^= rotl32(crc, r % 29), sumb ^= rotl32(crc, r % 31).  The XOR
    is associative, so partials over a partition of the sites combine by
    XOR into the whole file's checksum."""
    crcs = site_crc32(site_bytes)
    if crcs.size == 0:
        return 0, 0
    r = ranks.astype(np.uint64)
    suma = np.bitwise_xor.reduce(_rotl32(crcs, (r % 29).astype(np.uint32)))
    sumb = np.bitwise_xor.reduce(_rotl32(crcs, (r % 31).astype(np.uint32)))
    return int(suma), int(sumb)


def dml_checksum(site_bytes: np.ndarray, rank0: int = 0) -> tuple[int, int]:
    """QIO DML checksum (suma, sumb) of (V, bytes_per_site) uint8 rows
    whose first row is the site of global rank ``rank0``."""
    data = np.ascontiguousarray(site_bytes, dtype=np.uint8)
    lib = _codec()
    if lib is None:
        return partial_checksum(
            data, np.arange(rank0, rank0 + data.shape[0], dtype=np.uint64))
    out = (ctypes.c_uint32 * 2)()
    lib.dml_checksum(data.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_uint64(data.shape[0]),
                     ctypes.c_uint64(data.shape[1]),
                     ctypes.c_uint64(rank0), out)
    return int(out[0]), int(out[1])
