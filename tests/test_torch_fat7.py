"""Fat7 and HISQ link smearing of qex_tpu_torch against qex_tpu on 4^4
(complex128): make_imp_links with random coefficients (with and without
naik), hisq_links and hisq_links_lowmem to 1e-12 relative, the pullback
of hisq_links against a central difference, and the unit-gauge closed
form.  The pullback is held against JAX through the HISQ force in
tests/test_torch_hisq.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel,
                            single_threaded, t)
from qex_tpu.gauge import fat7 as jf7
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu_torch.gauge import fat7
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
TOL = 1e-12


def _coefs(mod, vals):
    return mod.Fat7lCoefs(*vals)


@pytest.fixture(scope="module")
def refs():
    """JAX references, one compiled program: make_imp_links with random
    coefficients (naik 0 and nonzero) and hisq_links."""
    rng = np.random.default_rng(41)
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat, 0.5)
    vals = tuple(rng.uniform(-0.5, 0.5, 5))
    naik = float(rng.uniform(-0.1, 0.1))
    jc = _coefs(jf7, vals)

    def ref(u):
        plain = jf7.make_imp_links(jlat, u, jc)[0]
        fl_n, ll_n = jf7.make_imp_links(jlat, u, jc, naik=naik)
        return (plain, fl_n, ll_n) + jf7.hisq_links(jlat, u)

    outs = compile_ref(ref, u)(u)
    return dict(u=u, vals=vals, naik=naik,
                outs=[np.asarray(o) for o in outs])


def test_hisq_coefficients_equal():
    for f7lf, naik in ((0.0, 0.0), (2.0, 1.0), (0.3, -0.7)):
        assert (dataclasses.asdict(fat7.set_hisq_fat7(f7lf, naik))
                == dataclasses.asdict(jf7.set_hisq_fat7(f7lf, naik)))
    assert (dataclasses.asdict(fat7.HisqCoefs())
            == dataclasses.asdict(jf7.HisqCoefs()))


@pytest.mark.parametrize("with_naik", [False, True])
def test_make_imp_links(refs, with_naik):
    lat = Lattice(DIMS)
    c = _coefs(fat7, refs["vals"])
    plain, fl_n, ll_n = refs["outs"][:3]
    if with_naik:
        fl, ll = fat7.make_imp_links(lat, t(refs["u"]), c,
                                     naik=refs["naik"])
        assert rel(n(fl), fl_n) < TOL
        assert rel(n(ll), ll_n) < TOL
    else:
        fl, ll = fat7.make_imp_links(lat, t(refs["u"]), c)
        assert ll is None
        assert rel(n(fl), plain) < TOL


def test_hisq_links(refs):
    fl_ref, ll_ref = refs["outs"][3:5]
    fl, ll = fat7.hisq_links(Lattice(DIMS), t(refs["u"]))
    assert rel(n(fl), fl_ref) < TOL
    assert rel(n(ll), ll_ref) < TOL


def test_hisq_links_lowmem(refs):
    """The forward-only route gives the JAX hisq_links (which the JAX
    tests hold equal to its own hisq_links_lowmem) and records
    nothing."""
    u = t(refs["u"]).requires_grad_(True)
    fl, ll = fat7.hisq_links_lowmem(Lattice(DIMS), u)
    assert not fl.requires_grad and not ll.requires_grad
    assert rel(n(fl), refs["outs"][3]) < TOL
    assert rel(n(ll), refs["outs"][4]) < TOL


def test_hisq_links_pullback_central_difference(refs):
    """d/de of L(u + e du) = Re sum conj(c) . (fat, long) at e = 0 equals
    Re sum conj(g) du for torch's gradient g (complex128; the central
    difference Richardson-extrapolated from steps 2e-5 and 1e-5).

    The backward is the exact derivative of the polar projection, while
    the forward runs a fixed number of Newton-Schulz steps.  Some
    first-level fat7 links of this field are nearly singular, where the
    default 14 steps leave the forward far from the projection: its
    derivative then differs from the backward by 87%, as in the JAX
    package (ROADMAP C4).  With 40 steps the two agree."""
    rng = np.random.default_rng(43)
    lat = Lattice(DIMS)
    cf, cl = (t(ginibre(rng, (4, 3, 3) + DIMS)) for _ in range(2))
    du = t(ginibre(rng, (4, 3, 3) + DIMS))

    def deviation(iters):
        def loss(v):
            fl, ll = fat7.hisq_links(lat, v, proj_iters=iters)
            return ((cf.conj() * fl).real.sum()
                    + (cl.conj() * ll).real.sum())

        u = t(refs["u"]).requires_grad_(True)
        (g,) = torch.autograd.grad(loss(u), u)
        ana = float((g.conj() * du).real.sum())
        with torch.no_grad():
            d1, d2 = (float(loss(u + h * du) - loss(u - h * du)) / (2 * h)
                      for h in (2e-5, 1e-5))
        return abs((4 * d2 - d1) / 3 - ana) / abs(ana)

    assert deviation(40) < 1e-7
    assert 0.8 < deviation(14) < 0.95


def test_fat7_unit_gauge_closed_form():
    """On unit links every path is the identity; multiplicities 3-staple
    6, Lepage 12, 5-staple 24, 7-staple 48."""
    lat = Lattice(DIMS)
    c = fat7.Fat7lCoefs(0.7, 0.11, 0.013, 0.0017, 0.19)
    uu = group.unit_gauge(lat, torch.complex128, device="cpu")
    fl, ll = fat7.make_imp_links(lat, uu, c, naik=0.25)
    w = (c.one_link - 6 * c.lepage + 6 * c.three_staple
         + 12 * c.lepage + 24 * c.five_staple + 48 * c.seven_staple)
    assert rel(n(fl), w * n(uu)) < 1e-15
    assert rel(n(ll), 0.25 * n(uu)) < 1e-15
