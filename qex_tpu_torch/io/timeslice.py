"""Per-timeslice lattice field records (copy of ``qex_tpu.io.timeslice``,
numpy only; QEX's src/io/timesliceIo.nim):
write/read one timeslice of a field as an independent big-endian
lexicographic record -- the building block for per-slice mode files
and streaming correlator sources.
"""

from __future__ import annotations

import numpy as np

from ..lattice import Lattice
from .lime import _from_lex_sites, _to_lex_sites, host_array


def _slice_lattice(lat: Lattice) -> Lattice:
    return Lattice(lat.dims[:-1] + (1,), nc=lat.nc)


def timeslice_bytes(lat: Lattice, arr, t: int,
                    precision: str = "F") -> bytes:
    """Extract timeslice ``t`` of a site-tensor-leading field as a
    big-endian lex-ordered record."""
    arr = host_array(arr)
    sl = arr[..., t:t + 1]
    lead = arr.shape[: arr.ndim - lat.nd]
    sites = _to_lex_sites(_slice_lattice(lat), sl, lead)
    bdt = (">c8" if precision == "F" else ">c16") \
        if np.iscomplexobj(arr) else \
        (">f4" if precision == "F" else ">f8")
    return sites.astype(bdt).tobytes()


def timeslice_from_bytes(lat: Lattice, raw: bytes, lead_shape,
                         precision: str = "F",
                         complex_data: bool = True) -> np.ndarray:
    """Decode one timeslice record -> array (*lead_shape, X, Y, Z, 1)."""
    bdt = (">c8" if precision == "F" else ">c16") \
        if complex_data else (">f4" if precision == "F" else ">f8")
    slat = _slice_lattice(lat)
    sites = np.frombuffer(raw, bdt).reshape(
        (slat.volume,) + tuple(lead_shape))
    return _from_lex_sites(slat, sites, lead_shape)


def write_timeslices(path: str, lat: Lattice, arr,
                     precision: str = "F") -> None:
    """All timeslices as consecutive records (one file, seekable)."""
    with open(path, "wb") as f:
        for t in range(lat.dims[-1]):
            f.write(timeslice_bytes(lat, arr, t, precision))


def read_timeslice(path: str, lat: Lattice, lead_shape, t: int,
                   precision: str = "F", complex_data: bool = True
                   ) -> np.ndarray:
    """Seek + read a single timeslice record."""
    slat = _slice_lattice(lat)
    itemsize = np.dtype(">c8" if precision == "F" else ">c16").itemsize \
        if complex_data else np.dtype(
        ">f4" if precision == "F" else ">f8").itemsize
    rec = int(np.prod(lead_shape)) * slat.volume * itemsize
    with open(path, "rb") as f:
        f.seek(t * rec)
        raw = f.read(rec)
    return timeslice_from_bytes(lat, raw, lead_shape, precision,
                                complex_data)
