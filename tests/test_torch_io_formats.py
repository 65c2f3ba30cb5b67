"""The port's MILC, modfile and timeslice formats, its checksum codec and
``lat_util`` against the JAX package's, on the host (numpy only: the
two packages' I/O modules compute nothing in JAX).

Each format is written by one package and read by the other, and the
files of both packages are byte for byte the same (qex_tpu's own checks:
tests/test_io.py:111-202)."""

import zlib

import numpy as np
import pytest
import torch

from _torch_helpers import ginibre
from qex_tpu.io import lime as jlime
from qex_tpu.io import milc as jmilc
from qex_tpu.io import modfile as jmodfile
from qex_tpu.io import timeslice as jtimeslice
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu_torch.apps import lat_util
from qex_tpu_torch.io import lime, milc, modfile, native, timeslice
from qex_tpu_torch.lattice import Lattice

DIMS = (4, 4, 4, 8)
STAMP = "Tue Aug 18 00:00:00 2026"


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(31)
    return ginibre(rng, (4, 3, 3) + DIMS)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_milc_interchange(tmp_path, field, writer):
    """A MILC file written by either package: the same bytes, read by
    both, the checksum catching a flipped byte; a big-endian file (the
    magic byte-reversed) reads the same."""
    lat, jlat = Lattice(DIMS), JLattice(DIMS)
    ours, theirs = str(tmp_path / "a.milc"), str(tmp_path / "b.milc")
    milc.save_milc(ours if writer == "port" else theirs, lat,
                   torch.from_numpy(field), timestamp=STAMP)
    jmilc.save_milc(theirs if writer == "port" else ours, jlat, field,
                    timestamp=STAMP)
    raw = open(ours, "rb").read()
    assert raw == open(theirs, "rb").read()
    got, ts = milc.load_milc(theirs)
    ref, jts = jmilc.load_milc(ours)
    assert ts == jts == STAMP
    assert np.array_equal(got, ref)
    assert np.array_equal(got, field.astype(np.complex64))
    # the same file big-endian: every 4-byte word of header and payload
    # reversed, the timestamp as it was
    hdr = jmilc._HDR.size
    words = np.frombuffer(raw[:20] + raw[84:hdr] + raw[hdr:], "<u4")
    swapped = words.astype(">u4").tobytes()
    big = str(tmp_path / "big.milc")
    open(big, "wb").write(swapped[:20] + raw[20:84] + swapped[20:])
    assert np.array_equal(milc.load_milc(big)[0], got)
    bad = bytearray(raw)
    bad[200] ^= 0xFF
    open(ours, "wb").write(bytes(bad))
    with pytest.raises(ValueError, match="checksum"):
        milc.load_milc(ours)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_modfile_interchange(tmp_path, field, writer):
    """A QDP modfile with a field record and a raw record: identical
    bytes from both writers, each reader reads the other's, and the map
    checksum catches a corrupted map."""
    lat, jlat = Lattice(DIMS), JLattice(DIMS)
    paths = {"port": str(tmp_path / "a.mod"), "jax": str(tmp_path / "b.mod")}
    key = modfile.pack_key((0, 3))
    assert key == jmodfile.pack_key((0, 3))
    assert modfile.unpack_key(key) == (0, 3)
    for who, mod, la, f in (("port", modfile, lat, torch.from_numpy(field[0])),
                            ("jax", jmodfile, jlat, field[0])):
        w = mod.ModFileWriter(paths[who], userdata="<info>eigvecs</info>")
        w.add_field(key, la, f, precision="D")
        w.add(b"rawkey", b"hello-payload")
        w.close()
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    other = paths["jax" if writer == "port" else "port"]
    r = modfile.ModFileReader(other)
    jr = jmodfile.ModFileReader(paths[writer])
    assert r.userdata == jr.userdata == "<info>eigvecs</info>"
    assert np.array_equal(r.read_field(key, lat, (3, 3), precision="D"),
                          jr.read_field(key, jlat, (3, 3), precision="D"))
    assert r.read(b"rawkey", 13) == b"hello-payload"
    r.close()
    jr.close()
    raw = bytearray(open(paths[writer], "rb").read())
    raw[-6] ^= 0xFF                    # inside the map body
    open(paths[writer], "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum|magic"):
        modfile.ModFileReader(paths[writer])


@pytest.mark.parametrize("precision", ["F", "D"])
def test_timeslice_interchange(tmp_path, field, precision):
    """Per-timeslice records: identical files, and each package's reader
    returns every timeslice of the other's file."""
    lat, jlat = Lattice(DIMS), JLattice(DIMS)
    ours, theirs = str(tmp_path / "a.ts"), str(tmp_path / "b.ts")
    timeslice.write_timeslices(ours, lat, torch.from_numpy(field[1]),
                               precision)
    jtimeslice.write_timeslices(theirs, jlat, field[1], precision)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for t in range(DIMS[-1]):
        got = timeslice.read_timeslice(theirs, lat, (3, 3), t, precision)
        ref = jtimeslice.read_timeslice(ours, jlat, (3, 3), t, precision)
        assert np.array_equal(got, ref)
    assert timeslice.timeslice_bytes(lat, field[1], 2, precision) == \
        jtimeslice.timeslice_bytes(jlat, field[1], 2, precision)


def test_checksum_codec_and_zlib_agree(field):
    """The g++-built codec and the zlib loop give the JAX package's DML
    checksum; ``native.last_route`` names the route that ran, and the
    partials of a split of the sites XOR to the whole."""
    lat = Lattice(DIMS)
    rows = np.frombuffer(lime._to_lex_sites(lat, field, (4, 3, 3))
                         .astype(">c8").tobytes(), np.uint8) \
        .reshape(lat.volume, -1)
    ref = jlime.dml_checksum(rows)
    assert native.dml_checksum(rows) == ref
    assert native.last_route == ("native" if native.library() else "zlib")
    with native.zlib_only():
        assert lime.dml_checksum(rows) == ref
        assert native.last_route == "zlib"
    ranks = np.arange(lat.volume)
    a = native.partial_checksum(rows[:100], ranks[:100])
    b = native.partial_checksum(rows[100:], ranks[100:])
    assert (a[0] ^ b[0], a[1] ^ b[1]) == ref
    assert np.array_equal(native.site_crc32(rows[:7]),
                          [zlib.crc32(r) for r in rows[:7]])


def test_lat_util_check_and_cmp(tmp_path, field, capsys):
    """``check`` prints the file's lattice and the plaquette of its
    links; ``cmp`` exits 0 on equal fields and 1 on different ones."""
    from qex_tpu_torch.gauge import loops
    lat = Lattice(DIMS)
    q, _ = np.linalg.qr(np.moveaxis(field, (1, 2), (-2, -1)))
    u = np.ascontiguousarray(np.moveaxis(q, (-2, -1), (1, 2)))
    f1, f2 = str(tmp_path / "a.lime"), str(tmp_path / "b.lime")
    lime.save_gauge(f1, lat, u, precision="D")
    lime.save_gauge(f2, lat, u + 1e-3, precision="D")
    assert lat_util.main(["check", f1, "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Lattice size: [4, 4, 4, 8]"
    plaq = float(loops.plaquette(lat, torch.from_numpy(u)))
    assert out[1] == f"plaq: {plaq:.10g}"
    assert lat_util.main(["cmp", f1, f1]) == 0
    assert lat_util.main(["cmp", f1, f2]) == 1
    assert "relative" in capsys.readouterr().out
