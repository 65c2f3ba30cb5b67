"""SciDAC / LIME lattice file format codec (copy of ``qex_tpu.io.lime``,
numpy only).

Wire-format compatible with SciDAC files, so gauge configurations
interchange with the reference and with the JAX package: a file written
by either package is byte-identical and reads in the other.

LIME record header (144 bytes, all big-endian; c-lime convention):
    int32   magic = 0x456789ab
    int16   version = 1
    int16   flags: MB (bit 15), ME (bit 14)
    uint64  data_length
    char    type[128] (null-padded)
Payload padded to a multiple of 8 bytes.

SciDAC gauge file record sequence (QIO volume format SINGLEFILE):
    scidac-private-file-xml, scidac-file-xml,
    scidac-private-record-xml, scidac-record-xml,
    scidac-binary-data, scidac-checksum

Binary payload: lexicographic site order with x fastest
(site = x + Lx*(y + Ly*(z + Lz*t))); per site ``datacount`` objects
(4 link matrices, mu = x,y,z,t), each row-major nc x nc complex,
big-endian IEEE (precision 'F' = f32, 'D' = f64).

DML checksum (QIO convention): per global site rank r,
crc = crc32(site bytes); suma ^= rotl32(crc, r % 29);
sumb ^= rotl32(crc, r % 31), computed by the host codec of
:mod:`.native` (g++-built, as the JAX package's), or by its per-site
``zlib.crc32`` loop where no compiler is present; ``native.last_route``
says which ran.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..lattice import Lattice
from . import native

LIME_MAGIC = 0x456789AB
_HDR = struct.Struct(">iHHQ128s")


@dataclasses.dataclass
class LimeRecord:
    type: str
    data: bytes
    mb: bool = False
    me: bool = False


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


def write_lime(path: str, records: list[LimeRecord]) -> None:
    """Write a LIME file; first record gets MB=1, last ME=1."""
    with open(path, "wb") as f:
        for i, rec in enumerate(records):
            mb = 1 if i == 0 or rec.mb else 0
            me = 1 if i == len(records) - 1 or rec.me else 0
            flags = (mb << 15) | (me << 14)
            f.write(_HDR.pack(LIME_MAGIC, 1, flags, len(rec.data),
                              rec.type.encode()))
            f.write(rec.data)
            f.write(b"\0" * _pad8(len(rec.data)))


def read_lime(path: str) -> list[LimeRecord]:
    """Read all records of a LIME file."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(144)
            if len(hdr) < 144:
                break
            magic, version, flags, length, rtype = _HDR.unpack(hdr)
            if magic & 0xFFFFFFFF != LIME_MAGIC:
                raise ValueError(f"bad LIME magic {magic:#x} in {path}")
            data = f.read(length)
            f.read(_pad8(length))
            out.append(LimeRecord(rtype.split(b"\0")[0].decode(), data,
                                  bool(flags & 0x8000),
                                  bool(flags & 0x4000)))
    return out


def dml_checksum(site_bytes: np.ndarray) -> tuple[int, int]:
    """QIO DML checksum of per-site binary data.

    site_bytes: (V, bytes_per_site) uint8, in lexicographic site order.
    Returns (suma, sumb).
    """
    return native.dml_checksum(site_bytes)


def host_array(u) -> np.ndarray:
    """numpy array of ``u``, a numpy array or a tensor on any device."""
    if hasattr(u, "detach"):
        return u.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(u)


def _to_lex_sites(lat: Lattice, arr: np.ndarray, per_site_shape
                  ) -> np.ndarray:
    """(..., *dims) site-tensor-leading array -> (V, *per_site_shape)
    in lexicographic order (x fastest)."""
    nd = lat.nd
    # move lattice axes to front in (t, z, y, x) order so C-flatten
    # makes x fastest
    lat_axes = list(range(arr.ndim - nd, arr.ndim))
    arr2 = np.moveaxis(arr, lat_axes, list(range(nd)))
    arr2 = np.transpose(arr2, axes=list(range(nd))[::-1]
                        + list(range(nd, arr2.ndim)))
    return np.ascontiguousarray(arr2).reshape((lat.volume,)
                                              + tuple(per_site_shape))


def _from_lex_sites(lat: Lattice, sites: np.ndarray, lead_shape
                    ) -> np.ndarray:
    """(V, *per_site) lexicographic -> (*lead_shape, *dims)."""
    nd = lat.nd
    dims_rev = tuple(reversed(lat.dims))
    a = sites.reshape(dims_rev + tuple(sites.shape[1:]))
    # now axes are (t, z, y, x, *per_site); bring lattice to back as
    # (x, y, z, t)... first reverse to (x, y, z, t)
    a = np.transpose(a, axes=list(range(nd))[::-1]
                     + list(range(nd, a.ndim)))
    # move per-site axes to front
    a = np.moveaxis(a, list(range(nd, a.ndim)),
                    list(range(a.ndim - nd)))
    return a.reshape(tuple(lead_shape) + lat.dims)


_PRIV_FILE_XML = ('<?xml version="1.0" encoding="UTF-8"?>'
                  "<scidacFile><version>1.1</version>"
                  "<spacetime>{nd}</spacetime><dims>{dims} </dims>"
                  "<volfmt>0</volfmt></scidacFile>")
_PRIV_REC_XML = ('<?xml version="1.0" encoding="UTF-8"?>'
                 "<scidacRecord><version>1.1</version>"
                 "<date>{date}</date><recordtype>0</recordtype>"
                 "<datatype>{datatype}</datatype>"
                 "<precision>{prec}</precision><colors>{nc}</colors>"
                 "<typesize>{typesize}</typesize>"
                 "<datacount>{count}</datacount></scidacRecord>")
_CKSUM_XML = ('<?xml version="1.0" encoding="UTF-8"?>'
              "<scidacChecksum><version>1.0</version>"
              "<suma>{suma:x}</suma><sumb>{sumb:x}</sumb>"
              "</scidacChecksum>")


def save_gauge(path: str, lat: Lattice, u, precision: str = "F",
               file_xml: str = "<title>qex_tpu gauge</title>",
               record_xml: str = "<info>qex_tpu</info>",
               date: str = "now") -> None:
    """Write a SciDAC gauge configuration (QEX ``saveGauge`` parity,
    gauge/gaugeUtils.nim:111-123); ``u`` a numpy array or a tensor on any
    device."""
    nd, nc = lat.nd, lat.nc
    fdtype = ">c8" if precision == "F" else ">c16"
    arr = host_array(u)
    if arr.shape != lat.gauge_shape():
        raise ValueError(f"gauge shape {arr.shape} != {lat.gauge_shape()}")
    # (nd, nc, nc, *dims) -> per site (nd, nc, nc), mu fastest object
    sites = _to_lex_sites(lat, arr, (nd, nc, nc))
    payload = sites.astype(fdtype).tobytes()
    bytes_per_site = nd * nc * nc * (8 if precision == "F" else 16)
    site_view = np.frombuffer(payload, np.uint8).reshape(
        lat.volume, bytes_per_site)
    suma, sumb = dml_checksum(site_view)
    typesize = nc * nc * (8 if precision == "F" else 16)
    recs = [
        LimeRecord("scidac-private-file-xml", _PRIV_FILE_XML.format(
            nd=nd, dims=" ".join(str(d) for d in lat.dims)).encode()),
        LimeRecord("scidac-file-xml", file_xml.encode()),
        LimeRecord("scidac-private-record-xml", _PRIV_REC_XML.format(
            date=date, datatype=f"QDP_{precision}{nc}_ColorMatrix",
            prec=precision, nc=nc, typesize=typesize, count=nd).encode()),
        LimeRecord("scidac-record-xml", record_xml.encode()),
        LimeRecord("scidac-binary-data", payload),
        LimeRecord("scidac-checksum", _CKSUM_XML.format(
            suma=suma, sumb=sumb).encode()),
    ]
    write_lime(path, recs)


def load_gauge(path: str, lat: Lattice, dtype=None):
    """Read a SciDAC/ILDG gauge configuration; verifies the DML
    checksum when present (QEX ``loadGauge``, gaugeUtils.nim:87-105).

    Returns a numpy array of lat.gauge_shape(); the caller moves it to
    a device (keeps this module host-only).
    """
    import re

    recs = {r.type: r for r in read_lime(path)}
    bin_rec = (recs.get("scidac-binary-data")
               or recs.get("ildg-binary-data"))
    if bin_rec is None:
        raise ValueError(f"no binary data record in {path}; records: "
                         f"{list(recs)}")
    nd, nc = lat.nd, lat.nc
    n_elems = lat.volume * nd * nc * nc
    nbytes = len(bin_rec.data)
    if nbytes == n_elems * 8:
        fdtype = ">c8"
    elif nbytes == n_elems * 16:
        fdtype = ">c16"
    else:
        raise ValueError(
            f"binary size {nbytes} does not match lattice {lat.dims} "
            f"gauge field (expect {n_elems * 8} or {n_elems * 16})")
    ck = recs.get("scidac-checksum")
    if ck is not None:
        bytes_per_site = nbytes // lat.volume
        site_view = np.frombuffer(bin_rec.data, np.uint8).reshape(
            lat.volume, bytes_per_site)
        suma, sumb = dml_checksum(site_view)
        m = re.search(rb"<suma>([0-9a-fA-F]+)</suma>", ck.data)
        m2 = re.search(rb"<sumb>([0-9a-fA-F]+)</sumb>", ck.data)
        if m and m2:
            want = (int(m.group(1), 16), int(m2.group(1), 16))
            if want != (suma, sumb):
                raise ValueError(
                    f"checksum mismatch in {path}: file {want}, "
                    f"computed ({suma:#x}, {sumb:#x})")
    sites = np.frombuffer(bin_rec.data, fdtype).reshape(
        lat.volume, nd, nc, nc)
    arr = _from_lex_sites(lat, sites, (nd, nc, nc))
    if dtype is not None:
        arr = arr.astype(dtype)
    else:
        arr = arr.astype("c8" if fdtype == ">c8" else "c16")
    return arr


def file_lattice(path: str) -> tuple[int, ...]:
    """Lattice dimensions recorded in a SciDAC/ILDG file (QEX
    ``getFileLattice``, io/qio.nim / stdUtils): parses the
    scidac-private-file-xml <dims> record, falling back to the
    ildg-format <lx>..<lt> fields."""
    import re

    recs = {r.type: r for r in read_lime(path)}
    pf = recs.get("scidac-private-file-xml")
    if pf is not None:
        m = re.search(rb"<dims>([\d\s]+)</dims>", pf.data)
        if m:
            return tuple(int(x) for x in m.group(1).split())
    fmt = recs.get("ildg-format")
    if fmt is not None:
        ds = []
        for tag in (b"lx", b"ly", b"lz", b"lt"):
            m = re.search(rb"<" + tag + rb">(\d+)</" + tag + rb">",
                          fmt.data)
            if m:
                ds.append(int(m.group(1)))
        if ds:
            return tuple(ds)
    raise ValueError(f"no lattice dimensions found in {path}")
