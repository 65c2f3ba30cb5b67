"""Cooperative single-file SciDAC parallel I/O (port of
``qex_tpu.io.pario``; QEX's parallelIo.nim:1-555 and iocommon.nim:3-40).

The ranks of a ``parallel.mesh.LatticeMesh`` write and read ONE
SciDAC-LIME file together: each rank writes its block's hyperrectangle
directly into the shared file at its lexicographic byte offsets (POSIX
concurrent non-overlapping writes through numpy memmaps) and reads back
only its own block.  The DML checksum is an XOR of per-site rotated
CRCs, so each rank computes the partial of its own sites
(``native.partial_checksum``, global site ranks) and the partials
combine by XOR, as QIO's DML_checksum_combine does: through per-rank
sidecar files beside the output and two barriers (``_combine_xor``, as
the JAX package), the barriers here ``torch.distributed.barrier``.

The file is byte for byte the one ``lime.save_gauge`` writes of the
gathered field, whatever the number of ranks.
"""

from __future__ import annotations

import os
import pathlib
import re

import numpy as np
import torch

from ..lattice import Lattice
from ..parallel.mesh import LatticeMesh
from . import native
from .lime import (LIME_MAGIC, _CKSUM_XML, _HDR, _PRIV_FILE_XML,
                   _PRIV_REC_XML, _pad8, host_array)


def _pack_rec(rtype: str, data: bytes, mb: bool, me: bool) -> bytes:
    flags = ((1 if mb else 0) << 15) | ((1 if me else 0) << 14)
    return (_HDR.pack(LIME_MAGIC, 1, flags, len(data), rtype.encode())
            + data + b"\0" * _pad8(len(data)))


def _combine_xor(lm: LatticeMesh, path: str, tag: str, suma: int,
                 sumb: int, nonce: int = 0) -> tuple[int, int]:
    """All-rank XOR of checksum partials through sidecar files and two
    barriers (QIO DML_checksum_combine).  ``nonce``, a value every rank
    agrees on (the payload offset), keys the sidecar names so that a
    crashed earlier call's stale sidecars are never read; each rank
    removes its own sidecar."""
    if lm.size == 1:
        return suma, sumb
    stem = f"{path}.qexck_{tag}{nonce:x}_"
    side = pathlib.Path(f"{stem}{lm.rank}")
    try:
        side.write_text(f"{suma:x} {sumb:x}")
        lm.barrier()
        ga = gb = 0
        for r in range(lm.size):
            a, b = pathlib.Path(f"{stem}{r}").read_text().split()
            ga ^= int(a, 16)
            gb ^= int(b, 16)
        lm.barrier()
    finally:
        try:
            os.remove(side)
        except OSError:
            pass
    return ga, gb


def _block_ranks(lat: Lattice, lat_slices) -> np.ndarray:
    """Global lexicographic site ranks (x fastest) of a hyperrectangle,
    flattened in C order over (t, z, y, x), the row order of the block
    payload."""
    sx, sy, sz, st = lat_slices
    Lx, Ly, Lz, _ = lat.dims
    xs = np.arange(sx.start, sx.stop, dtype=np.int64)
    ys = np.arange(sy.start, sy.stop, dtype=np.int64)
    zs = np.arange(sz.start, sz.stop, dtype=np.int64)
    ts = np.arange(st.start, st.stop, dtype=np.int64)
    r = (((ts[:, None, None, None] * Lz + zs[None, :, None, None])
          * Ly + ys[None, None, :, None]) * Lx
         + xs[None, None, None, :])
    return r.ravel()


def _block_to_tzyx(data: np.ndarray, nd: int) -> np.ndarray:
    """(lead..., X, Y, Z, T) block -> (T, Z, Y, X, lead...)."""
    ndim = data.ndim
    a = np.moveaxis(data, list(range(ndim - nd, ndim)), list(range(nd)))
    return np.transpose(a, axes=list(range(nd))[::-1]
                        + list(range(nd, ndim)))


def _gauge_layout(lat: Lattice, precision: str, file_xml: str,
                  record_xml: str, date: str):
    """Byte layout of the SciDAC gauge file: preamble records (those of
    ``lime.save_gauge``), binary-record header, payload offset and
    length, checksum-record offset, bytes per site."""
    nd, nc = lat.nd, lat.nc
    esize = 8 if precision == "F" else 16
    bps = nd * nc * nc * esize
    pre = [
        ("scidac-private-file-xml", _PRIV_FILE_XML.format(
            nd=nd, dims=" ".join(str(d) for d in lat.dims)).encode()),
        ("scidac-file-xml", file_xml.encode()),
        ("scidac-private-record-xml", _PRIV_REC_XML.format(
            date=date, datatype=f"QDP_{precision}{nc}_ColorMatrix",
            prec=precision, nc=nc, typesize=nc * nc * esize,
            count=nd).encode()),
        ("scidac-record-xml", record_xml.encode()),
    ]
    preamble = b"".join(_pack_rec(t, d, mb=(i == 0), me=False)
                        for i, (t, d) in enumerate(pre))
    payload_len = lat.volume * bps
    bin_hdr = _HDR.pack(LIME_MAGIC, 1, 0, payload_len, b"scidac-binary-data")
    payload_off = len(preamble) + len(bin_hdr)
    cksum_off = payload_off + payload_len + _pad8(payload_len)
    return preamble, bin_hdr, payload_off, payload_len, cksum_off, bps


def save_gauge_parallel(path: str, lat: Lattice, lm: LatticeMesh, block,
                        precision: str = "F",
                        file_xml: str = "<title>qex_tpu gauge</title>",
                        record_xml: str = "<info>qex_tpu</info>",
                        date: str = "now") -> None:
    """All ranks of ``lm`` write ONE SciDAC gauge file together; ``block``
    is this rank's block (nd, nc, nc, *local) of the gauge field, a
    tensor on any device or an array.  Byte-identical to
    ``lime.save_gauge`` of the whole field."""
    nd, nc = lat.nd, lat.nc
    if nd != 4:
        raise ValueError(f"pario supports 4D lattices only (got nd={nd})")
    arr = host_array(block)
    want = (nd, nc, nc) + lm.local_dims
    if tuple(arr.shape) != want:
        raise ValueError(f"gauge block shape {arr.shape} != {want}")
    fdtype = ">c8" if precision == "F" else ">c16"
    (preamble, bin_hdr, payload_off, _len, cksum_off,
     bps) = _gauge_layout(lat, precision, file_xml, record_xml, date)
    if lm.rank == 0:
        with open(path, "wb") as f:
            f.write(preamble)
            f.write(bin_hdr)
            f.truncate(cksum_off)
    lm.barrier()

    dims_rev = tuple(reversed(lat.dims))
    view = np.memmap(path, dtype=fdtype, mode="r+", offset=payload_off,
                     shape=dims_rev + (nd, nc, nc))
    sl = lm.block_slices()
    sx, sy, sz, st = sl
    blk = _block_to_tzyx(arr, nd)
    view[st, sz, sy, sx] = blk
    view.flush()
    del view
    rows = np.ascontiguousarray(blk.astype(fdtype)).view(np.uint8) \
        .reshape(-1, bps)
    suma, sumb = native.partial_checksum(rows, _block_ranks(lat, sl))
    lm.barrier()

    suma, sumb = _combine_xor(lm, path, "save", suma, sumb,
                              nonce=payload_off)
    if lm.rank == 0:
        with open(path, "r+b") as f:
            f.seek(cksum_off)
            f.write(_pack_rec("scidac-checksum", _CKSUM_XML.format(
                suma=suma, sumb=sumb).encode(), mb=False, me=True))
    lm.barrier()


def _scan_records(path: str):
    """Header-only LIME scan: [(type, data offset, length)] without
    reading payloads."""
    out = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off + 144 <= size:
            f.seek(off)
            magic, _ver, _flags, length, rtype = _HDR.unpack(f.read(144))
            if magic & 0xFFFFFFFF != LIME_MAGIC:
                raise ValueError(f"bad LIME magic at {off} in {path}")
            out.append((rtype.split(b"\0")[0].decode(), off + 144, length))
            off += 144 + length + _pad8(length)
    return out


def load_gauge_parallel(path: str, lat: Lattice, lm: LatticeMesh,
                        dtype=None, verify: bool = True, device=None
                        ) -> torch.Tensor:
    """All ranks of ``lm`` read ONE SciDAC gauge file together: each
    memmap-reads only its block and returns it as a tensor (nd, nc, nc,
    *local) on ``device`` (default the host).  The DML checksum, where
    the file has one, is verified from the ranks' partials over the raw
    file bytes; a mismatch raises on every rank."""
    nd, nc = lat.nd, lat.nc
    if nd != 4:
        raise ValueError(f"pario supports 4D lattices only (got nd={nd})")
    by_type = {t: (o, n) for t, o, n in _scan_records(path)}
    bin_ = by_type.get("scidac-binary-data") \
        or by_type.get("ildg-binary-data")
    if bin_ is None:
        raise ValueError(f"no binary data record in {path}")
    off, nbytes = bin_
    n_elems = lat.volume * nd * nc * nc
    if nbytes == n_elems * 8:
        fdtype = ">c8"
    elif nbytes == n_elems * 16:
        fdtype = ">c16"
    else:
        raise ValueError(f"binary size {nbytes} does not match "
                         f"lattice {lat.dims}")
    bps = nbytes // lat.volume
    view = np.memmap(path, dtype=fdtype, mode="r", offset=off,
                     shape=tuple(reversed(lat.dims)) + (nd, nc, nc))
    out_dtype = dtype if dtype is not None else (
        "c8" if fdtype == ">c8" else "c16")
    sl = lm.block_slices()
    sx, sy, sz, st = sl
    sub = np.ascontiguousarray(view[st, sz, sy, sx])   # (T,Z,Y,X,nd,nc,nc)
    a = np.moveaxis(np.transpose(sub, axes=(3, 2, 1, 0, 4, 5, 6)),
                    (4, 5, 6), (0, 1, 2))
    block = torch.from_numpy(np.ascontiguousarray(a.astype(out_dtype)))

    if verify and "scidac-checksum" in by_type:
        co, cn = by_type["scidac-checksum"]
        with open(path, "rb") as f:
            f.seek(co)
            ck = f.read(cn)
        m = re.search(rb"<suma>([0-9a-fA-F]+)</suma>", ck)
        m2 = re.search(rb"<sumb>([0-9a-fA-F]+)</sumb>", ck)
        if m and m2:
            # the raw file bytes of this block, whatever dtype was asked
            rows = sub.view(np.uint8).reshape(-1, bps)
            suma, sumb = native.partial_checksum(rows, _block_ranks(lat, sl))
            suma, sumb = _combine_xor(lm, path, "load", suma, sumb,
                                      nonce=off)
            want = (int(m.group(1), 16), int(m2.group(1), 16))
            if want != (suma, sumb):
                raise ValueError(
                    f"checksum mismatch in {path}: file "
                    f"({want[0]:#x}, {want[1]:#x}), computed "
                    f"({suma:#x}, {sumb:#x})")
    return block.to(device or "cpu")
