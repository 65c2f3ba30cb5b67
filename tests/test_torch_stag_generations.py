"""The four older staggered Dslash generations and the v3 split-mode
experiment of qex_tpu_torch against qex_tpu: v1 (``stag_pallas``), v2
(``stag_pallas2``), v3 (``stag_pallas3``), v4 (``stag_pallas4``) and the
modes of ``exp_pallas3.make_kernel`` (``qex_tpu_torch.bench.exp_pallas3``).

- Layout constructors and converters bit-exact against JAX (float32 and
  bfloat16 links), ``fits`` equal.
- Each plain twin in float64 against the JAX fast-layout operator in
  complex128, both parities, to relative deviation 1e-12.
- One interpret-mode call per JAX kernel at 4^4 (float32 planes, hence
  the kernel tests' squared-deviation bound of 1e-12), on links carried
  across by ``convert.stag_generation_from_reference``.  v2 and v4 have
  no JAX test of their own; these are their first checks.

The CUDA kernels themselves are checked against these twins on a card
by tests/test_torch_kernels_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_helpers import compile_ref, ginibre, n, random_links, rel, rel2, t
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import stag_pallas as jsp1
from qex_tpu.physics import stag_pallas2 as jsp2
from qex_tpu.physics import stag_pallas3 as jsp3
from qex_tpu.physics import stag_pallas4 as jsp4
from qex_tpu.physics import staggered as jst
from qex_tpu_torch import convert
from qex_tpu_torch.bench import exp_pallas3 as ep3
from qex_tpu_torch.bench import stag_generations as gens
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_pallas as sp1
from qex_tpu_torch.physics import stag_pallas2 as sp2
from qex_tpu_torch.physics import stag_pallas3 as sp3
from qex_tpu_torch.physics import stag_pallas4 as sp4
from qex_tpu_torch.physics import staggered as st

GEOMS = [(4, 4, 4, 4), (8, 4, 4, 8)]     # 8x4x4x8: X != Y
TOL = 1e-12
M = 0.25


@functools.lru_cache(maxsize=None)
def _reference(dims):
    """numpy-seeded links and spinor (complex128), and the JAX references
    of the layout and twin tests in one compiled program: the constructors of
    all three generations (links in float32 for v1, v2, v3 and bfloat16
    for v1, v3), the split and grid-major spinors, the fast-layout links,
    hop (both parities), d2ee and d2dd."""
    rng = np.random.default_rng(77)
    jlat = JLattice(dims)
    u = random_links(rng, jlat)
    x = ginibre(rng, (3, dims[3] // 2, dims[2], dims[1] * dims[0]))

    def refs(u, x):
        jfs = jsf.new_fast(jst.new_stag_eo(jlat, u))
        p1 = jsp1.new_pallas(jfs)
        p1b = jsp1.new_pallas(jfs, links_dtype=jnp.bfloat16)
        p2 = jsp2.new_pallas2(jfs)
        p3 = jsp3.new_pallas3(jfs)
        p3b = jsp3.new_pallas3(jfs, links_dtype=jnp.bfloat16)
        xs = jsp1._split(x)
        return {"v1": (p1.g_e, p1.g_o), "v1b": (p1b.g_e, p1b.g_o),
                "v2": (p2.g_e, p2.g_o), "v3": (p3.l_e, p3.l_o),
                "v3b": (p3b.l_e, p3b.l_o), "xs": xs,
                "xg": jsp2.to_gridmajor_spinor(xs),
                "xg_back": jsp2.from_gridmajor_spinor(
                    jsp2.to_gridmajor_spinor(xs)),
                "fast": (jfs.g_e, jfs.g_o),
                "ds": [jsf.dslash_fast(jfs, x, p) for p in (0, 1)],
                "ee": jsf.d2ee_fast(jfs, x, M),
                "dd": jsf.d2dd_fast(jfs, x, 0)}

    return u, x, compile_ref(refs, u, x)(u, x)


@pytest.fixture(scope="module", params=GEOMS, ids=["4^4", "8x4x4x8"])
def ops(request):
    """Both packages' fields and the JAX references (:func:`_reference`)
    on one geometry."""
    dims = request.param
    u, x, refs = _reference(dims)
    lat = Lattice(dims)
    fs = sf.new_fast(st.new_stag_eo(lat, t(u)))
    return JLattice(dims), lat, u, x, fs, refs


@pytest.fixture(scope="module")
def jax_layouts(ops):
    return ops[-1]


def _bits(a):
    """Raw bits of a float32 or bfloat16 array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16
                   else torch.int32).numpy()
        return a
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("links", ["f32", "bf16"])
def test_new_pallas_links_exact(ops, jax_layouts, links):
    fs = ops[4]
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    p1 = sp1.new_pallas(fs, ldt, device="cpu")
    ref = jax_layouts["v1" if links == "f32" else "v1b"]
    assert p1.g_e.dtype == ldt and p1.g_e.is_contiguous()
    assert tuple(p1.g_e.shape) == ref[0].shape
    assert np.array_equal(_bits(p1.g_e), _bits(ref[0]))
    assert np.array_equal(_bits(p1.g_o), _bits(ref[1]))


def test_new_pallas2_links_and_spinors_exact(ops, jax_layouts):
    _, _, _, x, fs, _ = ops
    p2 = sp2.new_pallas2(fs, device="cpu")
    ref = jax_layouts["v2"]
    assert p2.g_e.is_contiguous() and tuple(p2.g_e.shape) == ref[0].shape
    assert np.array_equal(n(p2.g_e), np.asarray(ref[0]))
    assert np.array_equal(n(p2.g_o), np.asarray(ref[1]))
    xs = sp1._split(t(x))
    assert np.array_equal(n(xs), np.asarray(jax_layouts["xs"]))
    xg = sp2.to_gridmajor_spinor(xs)
    assert xg.is_contiguous()
    assert np.array_equal(n(xg), np.asarray(jax_layouts["xg"]))
    assert np.array_equal(n(sp2.from_gridmajor_spinor(xg)),
                          np.asarray(jax_layouts["xg_back"]))


@pytest.mark.parametrize("links", ["f32", "bf16"])
def test_new_pallas3_links_exact(ops, jax_layouts, links):
    """A = +1/2 g_out, C = -1/2 shift(adj g_src), term-major, the
    bfloat16 rounding after the fold and the adjoint."""
    fs = ops[4]
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    p3 = sp3.new_pallas3(fs, ldt, device="cpu")
    ref = jax_layouts["v3" if links == "f32" else "v3b"]
    assert tuple(p3.l_e.shape) == ref[0].shape == sp3.links_shape(p3.lat)
    assert p3.l_e.dtype == ldt and p3.l_e.is_contiguous()
    assert np.array_equal(_bits(p3.l_e), _bits(ref[0]))
    assert np.array_equal(_bits(p3.l_o), _bits(ref[1]))


def test_fits_matches_jax():
    for dims in GEOMS + [(16, 16, 16, 16), (24, 24, 24, 24),
                         (32, 32, 32, 32), (32, 32, 32, 31)]:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            assert sp3.fits(Lattice(dims), tdt) == jsp3.fits(
                JLattice(dims), jdt), dims
    assert sp3.fits(Lattice((32,) * 4))
    assert not sp3.fits(Lattice((24,) * 4))


@pytest.fixture(scope="module")
def fast_refs(ops):
    """JAX fast-layout hop (both parities), d2ee and d2dd in
    complex128."""
    r = ops[-1]
    return r["ds"], r["ee"], r["dd"]


def _f64_operator(kind, fs):
    """(hop, d2ee, d2dd or None) of a generation on float64 links,
    acting on complex fast-layout vectors through its own layout."""
    lat = fs.lat
    if kind == "v2":
        op = sp2.PallasStagEO2(
            lat, sp2.to_gridmajor_links(sp1._split(fs.g_e, torch.float64)),
            sp2.to_gridmajor_links(sp1._split(fs.g_o, torch.float64)))

        def wrap(f):
            return lambda v, *a: sp1._join(sp2.from_gridmajor_spinor(f(
                op, sp2.to_gridmajor_spinor(sp1._split(v, torch.float64)),
                *a)))
        return wrap(sp2.dslash_pallas2), wrap(sp2.d2ee_pallas2), None
    if kind == "v1":
        op = sp1.new_pallas(fs, torch.float64, device="cpu")
        fns = (sp1.dslash_pallas, sp1.d2ee_pallas, None)
    else:
        op = sp3.new_pallas3(fs, torch.float64, device="cpu")
        mod = sp3 if kind == "v3" else sp4
        fns = (getattr(mod, f"dslash_pallas{kind[1]}"),
               getattr(mod, f"d2ee_pallas{kind[1]}"),
               getattr(mod, f"d2dd_pallas{kind[1]}"))

    def wrap(f):
        return None if f is None else (lambda v, *a: sp1._join(f(
            op, sp1._split(v, torch.float64), *a)))
    return tuple(wrap(f) for f in fns)


@pytest.mark.parametrize("kind", ["v1", "v2", "v3", "v4"])
def test_twin_float64_matches_fast(ops, fast_refs, kind):
    """The plain route of each generation (a CPU tensor takes the twin)
    in float64 against the JAX fast-layout operator in complex128."""
    _, _, _, x, fs, _ = ops
    ds, ee, dd = fast_refs
    hop, d2ee, d2dd = _f64_operator(kind, fs)
    for parity in (0, 1):
        assert rel(n(hop(t(x), parity)), ds[parity]) < TOL, parity
    assert rel(n(d2ee(t(x), M)), ee) < TOL
    if d2dd is not None:
        assert rel(n(d2dd(t(x), 0)), dd) < TOL


# --- one interpret-mode call per JAX kernel, 4^4 ----------------------------

IDIMS = (4, 4, 4, 4)


@pytest.fixture(scope="module")
def iops():
    """4^4 JAX fast-layout links (complex128) and a split float32
    spinor."""
    _, _, refs = _reference(IDIMS)
    return JLattice(IDIMS), Lattice(IDIMS), refs["fast"], \
        np.asarray(refs["xs"])


def _interpret(jlat, build, call, g, xs):
    """One compiled program: the JAX operator ``build(jfs)`` of the fast
    links ``g`` and ``call(op, xs)`` in interpret mode; returns (the
    operator with numpy links, the output).  Building inside the program
    keeps the JAX layout code out of eager dispatch, which compiles each
    op."""
    kind = []

    def fn(ge, go, xs):
        op = build(jsf.FastStagEO(jlat, ge, go))
        kind.append(type(op))
        return vars(op)[op_fields(op)[0]], vars(op)[op_fields(op)[1]], \
            call(op, xs)

    args = (*g, jnp.asarray(xs))
    le, lo, out = compile_ref(fn, *args)(*args)
    return kind[0](jlat, le, lo), np.asarray(out)


def op_fields(op):
    """Names of the two link arrays of a JAX v1/v2 or v3 operator."""
    return ("l_e", "l_o") if hasattr(op, "l_e") else ("g_e", "g_o")


@pytest.mark.parametrize("kind,parity", [("v1", 0), ("v2", 1),
                                         ("v3-bf16", 1), ("v4", 1),
                                         ("v4-co", 0)])
def test_twin_matches_pallas_interpret(iops, kind, parity):
    """The port's hop on links carried across from the JAX operator
    against the JAX Pallas kernel in interpret mode.  v3's one call
    takes bfloat16 links (the sloppy operator); v4's takes v3's float32
    links, so both link types of ``PallasStagEO3`` meet a JAX kernel."""
    jlat, lat, u, xs = iops
    if kind == "v1":
        jp, ref = _interpret(jlat, jsp1.new_pallas, lambda op, v: (
            jsp1.dslash_pallas(op, v, parity, interpret=True)), u, xs)
        p = convert.stag_generation_from_reference(jp, device="cpu")
        assert isinstance(p, sp1.PallasStagEO)
        got = sp1.dslash_pallas(p, t(xs), parity)
    elif kind == "v2":
        jp, ref = _interpret(jlat, jsp2.new_pallas2, lambda op, v: (
            jsp2.dslash_pallas2(op, jsp2.to_gridmajor_spinor(v), parity,
                                interpret=True)), u, xs)
        p = convert.stag_generation_from_reference(jp, device="cpu")
        assert isinstance(p, sp2.PallasStagEO2)
        got = sp2.dslash_pallas2(p, sp2.to_gridmajor_spinor(t(xs)), parity)
    else:
        bf16 = kind == "v3-bf16"
        ldt = jnp.bfloat16 if bf16 else jnp.float32
        if kind.startswith("v3"):
            def call(op, v):
                return jsp3.dslash_pallas3(op, v, parity, interpret=True)
        else:
            def call(op, v):
                return jsp4.dslash_pallas4(op, v, parity, interpret=True,
                                           compute_only=kind == "v4-co")
        jp, ref = _interpret(jlat, lambda f: jsp3.new_pallas3(f, ldt), call,
                             u, xs)
        p = convert.stag_generation_from_reference(jp, device="cpu")
        assert isinstance(p, sp3.PallasStagEO3)
        assert p.l_e.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert np.array_equal(_bits(p.l_o), _bits(jp.l_o))
        if kind == "v4-co":
            got = sp4.dslash_pallas4(p, t(xs), parity, compute_only=True)
        elif kind == "v4":
            got = sp4.dslash_pallas4(p, t(xs), parity)
        else:
            got = sp3.dslash_pallas3(p, t(xs), parity)
    assert got.dtype == torch.float32
    assert rel2(n(got), ref) < TOL


def _split_kernel(jlat, parity, mode):
    """(l, v) -> exp_pallas3.make_kernel(mode) through pl.pallas_call in
    interpret mode, with the BlockSpecs of exp_pallas3.run (which has no
    interpret flag)."""
    import exp_pallas3 as jep3
    X, Y, Z, T = jlat.dims
    Th, YX = T // 2, Y * X

    def spin(im):
        return pl.BlockSpec((2, 3, 1, Z, YX), im, memory_space=pltpu.VMEM)

    return lambda l, v: pl.pallas_call(
        jep3.make_kernel(X, parity, 2, mode), grid=(Th,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY),
                  spin(lambda th: (0, 0, th, 0, 0)),
                  spin(lambda th: (0, 0, (th - 1) % Th, 0, 0)),
                  spin(lambda th: (0, 0, (th + 1) % Th, 0, 0))],
        out_specs=spin(lambda th: (0, 0, th, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((2, 3, Th, Z, YX), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, 2, 3, 3, Z, YX), l.dtype),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)(l, v, v, v)


@pytest.mark.parametrize("mode,parity", [("dma", 1), ("shifts", 0),
                                         ("full", 1)])
def test_split_modes_match_pallas_interpret(iops, mode, parity):
    """B8's modes that the JAX kernel defines (dma, shifts, full)."""
    jlat, lat, u, xs = iops
    kern = _split_kernel(jlat, parity, mode)
    jp, ref = _interpret(jlat, jsp3.new_pallas3, lambda op, v: kern(
        op.l_e if parity == 0 else op.l_o, v), u, xs)
    p = convert.stag_generation_from_reference(jp, device="cpu")
    got = ep3.run(p.l_e if parity == 0 else p.l_o, t(xs), lat, parity, mode)
    assert rel2(n(got), ref) < TOL


# --- the split modes' definitions, and the generation benchmark ---------

def _f64_v3(ops):
    _, lat, _, x, fs, _ = ops
    return lat, sp3.new_pallas3(fs, torch.float64, device="cpu"), \
        sp1._split(t(x), torch.float64)


def test_split_full_is_half_f_minus_b_not_v3(ops):
    """ROADMAP C8: exp_pallas3's ``full`` on v3's links is 1/2 (F - B),
    not v3's F + B (F, B the forward and backward terms).  The port
    computes what the JAX kernel computes (held against it in interpret
    mode above), so the quirk cannot be fixed in the port alone."""
    lat, p3, xs = _f64_v3(ops)
    for parity in (0, 1):
        l = p3.l_e if parity == 0 else p3.l_o
        terms = ep3.terms_plain(l, xs, lat, parity, "full")
        f, b = terms[:4].sum(0), terms[4:].sum(0)
        full = ep3.run(l, xs, lat, parity, "full")
        v3 = sp3.dslash_pallas3(p3, xs, parity)
        assert rel(n(full), n(0.5 * (f - b))) < TOL
        assert rel(n(v3), n(f + b)) < TOL
        assert rel2(n(full), n(v3)) > 1.0       # 1.25 for random fields


def test_split_modes_without_a_jax_kernel(ops):
    """matvec and compute, whose JAX kernel reads unwritten scratch, take
    L_0 in every term (compute: term k = L_0 psi(x + d_k), as v4's
    compute_only; matvec: L_0 psi(x), so the terms cancel); dma takes
    column 0 of each link."""
    lat, p3, xs = _f64_v3(ops)
    l = p3.l_o
    co = sp4.dslash_pallas4(p3, xs, 1, compute_only=True)
    terms = ep3.terms_plain(l, xs, lat, 1, "compute")
    assert rel(n(terms.sum(0)), n(co)) < TOL
    comp = ep3.run(l, xs, lat, 1, "compute")
    assert rel(n(comp), n(0.5 * (terms[:4].sum(0) - terms[4:].sum(0)))) \
        < TOL
    mv = ep3.terms_plain(l, xs, lat, 1, "matvec")
    assert all(torch.equal(mv[k], mv[0]) for k in range(8))
    shifted = ep3.terms_plain(l, xs, lat, 1, "shifts")
    assert torch.equal(shifted[4], sp1._split(sf.shift_fast(
        sp1._join(xs), 0, -1, 1, lat), torch.float64))
    out = ep3.run(l, xs, lat, 1, "matvec")
    assert float(out.abs().max()) <= 1e-14 * float(mv[0].abs().max())
    dma = ep3.run(l, xs, lat, 1, "dma")
    # site (th=1, z=2, yx=3), row 2, imaginary part
    col = [float(l[k, 1, 1, 2, 0, 2, 3]) for k in range(8)]
    assert float(dma[1, 2, 1, 2, 3]) == pytest.approx(
        0.5 * (sum(col[:4]) - sum(col[4:])), rel=1e-14)
    with pytest.raises(ValueError):
        ep3.run(l, xs, lat, 1, "fused")


def test_generation_benchmark_on_the_host():
    """The benchmark's instances, bytes model, layouts and checks (on the
    host the hops take their twins; timing needs the card)."""
    lat = Lattice((4, 4, 4, 4))
    s, x = gens.setup(lat, device="cpu")
    assert x.dtype == torch.complex64
    assert abs(float(x.abs().pow(2).sum()) - 1.0) < 1e-5
    insts = gens.all_instances()
    assert len({i.label for i in insts}) == len(insts) == 16
    f32, bf = torch.float32, torch.bfloat16
    I = gens.Instance
    assert [gens.bytes_per_site(i) for i in (
        I("v1"), I("v3", bf), I("v4", compute_only=True),
        I("v4", bf, compute_only=True))] == [624, 336, 120, 84]
    assert [gens.bytes_per_site(I("split", f32, mode=m))
            for m in ep3.MODES] == [600, 120, 48, 120, 624]
    for inst in insts:
        v = gens.to_layout(inst.kind, x)
        assert torch.equal(gens.from_layout(inst.kind, v), x)
        dev = gens.check(inst, gens.build(inst, s), s, x)
        if inst.kind == "split" or inst.compute_only:
            assert dev == 0.0, inst.label
        else:
            assert dev < (1e-4 if inst.links_dtype == bf else 1e-12), \
                inst.label
    with pytest.raises(ValueError):
        gens.build(I("v2", bf), s)
    with pytest.raises(ValueError):
        gens.build(I("split", bf, mode="full"), s)
    if not torch.cuda.is_available():
        assert gens.main(["--lattice", "4", "4", "4", "4"]) == 2


def test_wrappers_reject_other_devices(ops):
    """A tensor neither on the host nor on a card raises (it never takes
    the twin)."""
    _, lat, _, x, fs, _ = ops
    xs = sp1._split(t(x)).to("meta")
    p1 = sp1.new_pallas(fs, device="cpu")
    p3 = sp3.new_pallas3(fs, device="cpu")
    for call in (lambda: sp1.dslash_pallas(p1, xs, 0),
                 lambda: sp2.dslash_pallas2(sp2.new_pallas2(fs, device="cpu"),
                                            sp2.to_gridmajor_spinor(xs), 0),
                 lambda: sp3.dslash_pallas3(p3, xs, 0),
                 lambda: sp4.dslash_pallas4(p3, xs, 0, compute_only=True),
                 lambda: ep3.run(p3.l_e, xs, lat, 0, "shifts")):
        with pytest.raises(ValueError):
            call()


def test_cg_on_split_vectors(ops):
    """solvers.cg on the split re/im vectors of a generation (redot of
    real tensors) takes the steps of CG on the complex fast layout."""
    from qex_tpu_torch.solvers import cg
    _, _, _, x, fs, _ = ops
    p1 = sp1.new_pallas(fs, torch.float64, device="cpu")
    b = t(x)
    xs, st_s = cg.cg_solve(lambda v: sp1.d2ee_pallas(p1, v, 0.3),
                           sp1._split(b, torch.float64), r2req=1e-20,
                           maxits=40)
    xc, st_c = cg.cg_solve(lambda v: sf.d2ee_fast(fs, v, 0.3), b,
                           r2req=1e-20, maxits=40)
    assert st_s.iterations == st_c.iterations
    assert rel(n(sp1._join(xs)), n(xc)) < 1e-10
