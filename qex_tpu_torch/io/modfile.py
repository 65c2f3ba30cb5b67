"""MILC/QDP 'LazyDiskMapObj' mode files (eigenvector storage; copy of
``qex_tpu.io.modfile``, numpy only; QEX's src/io/modfile.nim):
wire-format-compatible reader/writer for the QDP lazy-disk-map format
used to store Dirac eigenvectors:

    header:  modString(magic="XXXXQDPLazyDiskMapObjFileXXXX")
             int32 version
             modString(userdata)
             int64 0
             int64 mapstart
    records: raw payloads at recorded offsets
    map (at mapstart, crc32-protected):
             int32 num; per entry: modString(key), int64 0, int64 pos
             int32 crc32  (of the map bytes)

All integers big-endian; modString = int32 length + bytes.  Keys are
commonly packed big-endian int32 tuples (``pack_key``).  Field payloads
are big-endian lexicographic site data (x fastest), matching
the conventions of io.lime.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable

import numpy as np

from ..lattice import Lattice
from .lime import _from_lex_sites, _to_lex_sites, host_array

MAGIC = "XXXXQDPLazyDiskMapObjFileXXXX"


def _mod_string(s: bytes) -> bytes:
    return struct.pack(">i", len(s)) + s


def pack_key(v: Iterable[int]) -> bytes:
    """Big-endian int32 tuple key (modfile.nim packKey)."""
    return b"".join(struct.pack(">i", int(x)) for x in v)


def unpack_key(k: bytes) -> tuple[int, ...]:
    return struct.unpack(f">{len(k) // 4}i", k)


class ModFileWriter:
    """Streaming writer: add records, close() writes the map."""

    def __init__(self, path: str, userdata: str = ""):
        self.f = open(path, "w+b")
        self.map: dict[bytes, int] = {}
        ud = userdata.encode()
        self.f.write(_mod_string(MAGIC.encode()))
        self.f.write(struct.pack(">i", 1))
        self.f.write(_mod_string(ud))
        self._mapstart_pos = self.f.tell() + 8
        self.f.write(struct.pack(">q", 0))
        self.f.write(struct.pack(">q", 0))   # mapstart placeholder

    def add(self, key: bytes, payload: bytes) -> None:
        self.map[key] = self.f.tell()
        self.f.write(payload)

    def add_field(self, key: bytes, lat: Lattice, arr,
                  precision: str = "F") -> None:
        """Store a site-tensor-leading lattice field big-endian lex."""
        arr = host_array(arr)
        lead = arr.shape[: arr.ndim - lat.nd]
        sites = _to_lex_sites(lat, arr, lead)
        bdt = (">c8" if precision == "F" else ">c16") \
            if np.iscomplexobj(arr) else \
            (">f4" if precision == "F" else ">f8")
        self.add(key, sites.astype(bdt).tobytes())

    def close(self) -> None:
        mapstart = self.f.tell()
        body = struct.pack(">i", len(self.map))
        for k, pos in self.map.items():
            body += _mod_string(k) + struct.pack(">q", 0) \
                + struct.pack(">q", pos)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        self.f.write(body)
        self.f.write(struct.pack(">i", crc - (1 << 32) if crc >= 1 << 31
                                 else crc))
        self.f.seek(self._mapstart_pos)
        self.f.write(struct.pack(">q", mapstart))
        self.f.close()


class ModFileReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        magic = self._read_string()
        if magic != MAGIC.encode():
            raise ValueError(f"bad modfile magic {magic!r}")
        (self.version,) = struct.unpack(">i", self.f.read(4))
        self.userdata = self._read_string().decode()
        self.f.read(8)
        (mapstart,) = struct.unpack(">q", self.f.read(8))
        self.f.seek(mapstart)
        body_start = self.f.tell()
        (num,) = struct.unpack(">i", self.f.read(4))
        self.map: dict[bytes, int] = {}
        for _ in range(num):
            k = self._read_string()
            self.f.read(8)
            (pos,) = struct.unpack(">q", self.f.read(8))
            self.map[k] = pos
        body_end = self.f.tell()
        (crc_file,) = struct.unpack(">i", self.f.read(4))
        self.f.seek(body_start)
        body = self.f.read(body_end - body_start)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        if crc != crc_file & 0xFFFFFFFF:
            raise ValueError("modfile map checksum mismatch")

    def _read_string(self) -> bytes:
        (n,) = struct.unpack(">i", self.f.read(4))
        return self.f.read(n)

    def read(self, key: bytes, nbytes: int) -> bytes:
        self.f.seek(self.map[key])
        return self.f.read(nbytes)

    def read_field(self, key: bytes, lat: Lattice, lead_shape,
                   precision: str = "F", complex_data: bool = True):
        bdt = (">c8" if precision == "F" else ">c16") \
            if complex_data else (">f4" if precision == "F" else ">f8")
        itemsize = np.dtype(bdt).itemsize
        n = int(np.prod(lead_shape)) * lat.volume
        raw = self.read(key, n * itemsize)
        sites = np.frombuffer(raw, bdt).reshape(
            (lat.volume,) + tuple(lead_shape))
        return _from_lex_sites(lat, sites, lead_shape)

    def close(self):
        self.f.close()
