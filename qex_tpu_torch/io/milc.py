"""MILC single-file gauge configuration format (copy of ``qex_tpu.io.milc``,
numpy only; QEX's src/new/milcIO.nim /
milcFileField.nim prototype (header layout :13-41, rotated-xor
checksum :46-58): magic 20103, int32 dims[4], 64-char timestamp,
int32 order (0 = coordinate serial order), checksum (sum29, sum31),
then 4 x 3 x 3 complex float32 per site, x fastest / t slowest — the
same lexicographic site order as SciDAC, so the codec shares
lime._to_lex_sites.

Endianness is auto-detected on read via the magic number (MILC
readers byte-reverse when the magic mismatches); files are written
little-endian.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from ..lattice import Lattice
from .lime import _from_lex_sites, _to_lex_sites, host_array

MILC_MAGIC = 20103
_HDR = struct.Struct("<i4i64si2I")      # magic, dims, stamp, order, cksum


def milc_checksum(words: np.ndarray, offset: int = 0
                  ) -> tuple[int, int]:
    """(sum29, sum31): xor of each uint32 word rotated left by its
    word-index mod 29 / mod 31 (milcIO.nim:46-58)."""
    n = words.size
    k = (np.arange(offset, offset + n, dtype=np.uint64))
    w = words.astype(np.uint64)

    def rot(m):
        r = (k % m).astype(np.uint64)
        v = ((w << r) | (w >> (np.uint64(32) - r))) \
            & np.uint64(0xFFFFFFFF)
        return int(np.bitwise_xor.reduce(v))

    return rot(29), rot(31)


def save_milc(path: str, lat: Lattice, u,
              timestamp: str | None = None) -> None:
    """Write a MILC-format gauge configuration (f32 precision)."""
    nd, nc = lat.nd, lat.nc
    if nd != 4:
        raise ValueError("MILC format is 4D only")
    arr = host_array(u)
    if arr.shape != lat.gauge_shape():
        raise ValueError(f"gauge shape {arr.shape} != "
                         f"{lat.gauge_shape()}")
    sites = _to_lex_sites(lat, arr, (nd, nc, nc)).astype("<c8")
    payload = sites.tobytes()
    words = np.frombuffer(payload, "<u4")
    s29, s31 = milc_checksum(words)
    ts = (timestamp or time.strftime("%a %b %d %H:%M:%S %Y"))
    hdr = _HDR.pack(MILC_MAGIC, *lat.dims,
                    ts.encode()[:64].ljust(64, b"\0"), 0, s29, s31)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(payload)


def load_milc(path: str, lat: Lattice | None = None, dtype=None):
    """Read a MILC-format gauge configuration; verifies the checksum.

    Returns (array of lat.gauge_shape(), timestamp).  ``lat`` defaults
    to the header dimensions.
    """
    with open(path, "rb") as f:
        raw = f.read()
    magic = struct.unpack_from("<i", raw)[0]
    if magic == MILC_MAGIC:
        end = "<"
    elif struct.unpack_from(">i", raw)[0] == MILC_MAGIC:
        end = ">"
    else:
        raise ValueError(f"{path}: bad MILC magic {magic:#x}")
    m, d0, d1, d2, d3, ts, order, s29, s31 = struct.unpack_from(
        end + "i4i64si2I", raw)
    dims = (d0, d1, d2, d3)
    if lat is None:
        lat = Lattice(dims)
    elif lat.dims != dims:
        raise ValueError(f"{path}: header dims {dims} != "
                         f"lattice {lat.dims}")
    if order != 0:
        raise ValueError(f"{path}: coordinate-list order "
                         "(order != 0) not supported")
    nd, nc = lat.nd, lat.nc
    n = lat.volume * nd * nc * nc
    payload = raw[_HDR.size:_HDR.size + n * 8]
    if len(payload) != n * 8:
        raise ValueError(f"{path}: truncated payload "
                         f"({len(payload)} != {n * 8})")
    words = np.frombuffer(payload, end + "u4")
    c29, c31 = milc_checksum(words)
    if (c29, c31) != (s29, s31):
        raise ValueError(f"{path}: checksum mismatch file "
                         f"({s29:#x},{s31:#x}) != computed "
                         f"({c29:#x},{c31:#x})")
    sites = np.frombuffer(payload, end + "c8").reshape(
        lat.volume, nd, nc, nc)
    arr = _from_lex_sites(lat, sites, (nd, nc, nc))
    arr = arr.astype(dtype if dtype is not None else "c8")
    return arr, ts.split(b"\0")[0].decode(errors="replace")
