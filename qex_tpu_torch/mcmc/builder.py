"""JSON-driven lattice field theory builder (port of
``qex_tpu.mcmc.builder.theory_from_json``).

It accepts the JSON schema of the reference's example decks: ``hmc``
(lattice geometry, trajectory length, seeds, start), ``action``
(smearing and boundary conditions), ``gauge``, the matter sections
``staggered-fermions`` (with ``hasenbusch-masses``),
``rooted-staggered-fermions``, ``staggered-pauli-villars`` and
``staggered-boson`` with per-field steps and integrators, ``solver``,
and ``flow`` measurement configs, which it passes on in ``meta``.  A
deck's ``mpi-geometry`` splits the lattice over the ranks of the default
process group (``parallel.mesh``); the run then needs that many ranks.
"""

from __future__ import annotations

import json

from ..gauge import action as ga
from ..gauge.smear import HypCoefs, StoutCoefs
from ..lattice import Lattice
from ..parallel.mesh import make_lattice_mesh
from ..solvers.base import SolverParams
from .theory import FermionSpec, GaugeActionSpec, LatticeFieldTheory

_MATTER_SECTIONS = {
    "staggered-fermions": "fermion",
    "rooted-staggered-fermions": "rooted",
    "staggered-pauli-villars": "boson",
    "staggered-boson": "boson",
}


def _gauge_coeffs(g: dict) -> ga.GaugeActionCoeffs:
    act = g.get("action", "Wilson").lower()
    beta = float(g.get("beta", 6.0))
    if act == "wilson":
        return ga.wilson(beta)
    if act in ("rectangle", "rect"):
        return ga.gauge_act_rect(beta, float(g.get("cr", -1.0 / 12.0)))
    if act == "adjoint":
        return ga.adjoint_action(beta, float(g.get("adjoint-ratio", -0.25)))
    if act == "symanzik":
        return ga.symanzik(beta)
    if act == "iwasaki":
        return ga.iwasaki(beta)
    if act == "dbw2":
        return ga.dbw2(beta)
    raise ValueError(f"unknown gauge action {g.get('action')!r}")


def theory_from_json(src: str | dict
                     ) -> tuple[Lattice, LatticeFieldTheory, dict]:
    """(lattice, theory, meta) from a reference-format JSON deck (a path
    or a parsed dict).  ``meta`` carries what the app needs: ``tau``,
    ``serial_seed``, ``parallel_seed``, ``start``, ``flow`` and
    ``mesh``: the ``parallel.mesh.LatticeMesh`` of the deck's
    ``mpi-geometry`` over the default process group (which must hold
    that many ranks), else None.  With a mesh the theory is
    block-resident (``mcmc.theory``): its methods take and return this
    rank's block of the links (``SolverParams.mesh``)."""
    if isinstance(src, str):
        with open(src) as f:
            cfg = json.load(f)
    else:
        cfg = dict(src)

    hmc = cfg.get("hmc", {})
    lat = Lattice(tuple(hmc.get("lattice-geometry", [4, 4, 4, 4])))
    lm = None
    if hmc.get("mpi-geometry"):
        lm = make_lattice_mesh(lat, rank_geom=[int(x) for x in
                                               hmc["mpi-geometry"]])
    tau = float(hmc.get("trajectory-length", 1.0))

    act = cfg.get("action", {})
    smear = None
    smkind = act.get("smearing", "none").lower()
    if smkind == "nhyp":
        a = act.get("smearing-coefficients", [0.4, 0.5, 0.5])
        smear = HypCoefs(*[float(x) for x in a])
    elif smkind == "stout":
        a = act.get("smearing-coefficients", [0.1])
        smear = StoutCoefs(float(a[0]) if isinstance(a, (list, tuple))
                           else float(a))
    elif smkind not in ("none", ""):
        raise ValueError(f"unknown smearing kind {smkind!r}")
    bc = act.get("boundary-conditions", "pppa")

    g = cfg.get("gauge", {})
    gauge = GaugeActionSpec(_gauge_coeffs(g), steps=int(g.get("steps", 10)),
                            scheme=str(g.get("integrator", "2MN")),
                            smeared=bool(g.get("smeared", False)))

    fermions: list[FermionSpec] = []
    for section, kind in _MATTER_SECTIONS.items():
        if section not in cfg:
            continue
        entries = cfg[section]
        if isinstance(entries, dict):
            entries = [entries]
        for e in entries:
            # 'species': the number of identical fields; 0 disables the
            # section
            for _ in range(int(e.get("species", 1))):
                fermions.append(FermionSpec(
                    kind, float(e.get("mass", 0.1)),
                    steps=int(e.get("steps", 10)),
                    scheme=str(e.get("integrator", "2MN")),
                    smeared=smear is not None, nf=int(e.get("nf", 1)),
                    hmasses=tuple(e.get("hasenbusch-masses", ()))))

    solver = cfg.get("solver", {})
    sp = SolverParams(r2req=float(solver.get("tolerance", 1e-12)),
                      maxits=int(solver.get("max-iterations", 2000)),
                      restarts=int(solver.get("restarts", 3)), mesh=lm)
    theory = LatticeFieldTheory(lat, gauge, fermions, smear=smear, bc=bc,
                                solver_params=sp, tau=tau)
    meta = {
        "tau": tau,
        "serial_seed": int(hmc.get("serial-random-number-seed", 0)),
        "parallel_seed": int(hmc.get("parallel-random-number-seed", 0)),
        "start": hmc.get("start", "cold"),
        "flow": cfg.get("flow", {}),
        "mesh": lm,
    }
    return lat, theory, meta
