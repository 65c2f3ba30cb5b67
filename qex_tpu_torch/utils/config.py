"""Configuration decks (port of ``HMCConfig`` and ``FlowConfig`` from
``qex_tpu.utils.config``, a copy, not an import): the staghmc_spv XML
deck, flat JSON decks and ``-key=value`` overrides mapped onto one
dataclass, and the gauge_flow XML deck.  The XML tag names are the
reference's, so existing decks parse unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import xml.etree.ElementTree as ET
from typing import Any


def _get(root: ET.Element, path: str, default=None, cast=str):
    el = root.find(path)
    if el is None or el.text is None:
        if default is None:
            raise KeyError(f"missing config entry {path!r}")
        return default
    txt = el.text.strip()
    if cast is bool:
        return txt.lower() in ("1", "true", "yes")
    return cast(txt)


@dataclasses.dataclass
class HMCConfig:
    """Unified schema of the staghmc_spv XML deck
    (src/stagg_pv_hmc/input_hmc.xml)."""

    # <hmc>
    tau: float = 1.0
    g_steps: int = 10
    sg_steps: int = 10
    f_steps: int = 10
    pv_steps: int = 10
    gauge_int_alg: str = "2MN"
    smeared_gauge_int_alg: str = "2MN"
    ferm_int_alg: str = "2MN"
    pv_int_alg: str = "2MN"
    no_metropolis_until: int = 1
    num_trajectories: int = 10
    # <config_opts>
    start_config: int = 0
    start: str = "cold"          # "cold" | "hot" | file path
    save_freq: int = 0
    save_path: str = "."
    save_filename: str = "config"
    # <rng>
    rng_type: str = "threefry"   # kept for deck parity; the port seeds
    #                              torch generators from (seed, traj)
    parallel_seed: int = 987654321
    serial_seed: int = 987654321
    # <action><geom>
    ns: int = 4
    nt: int = 4
    num_ns: int = 3
    num_nt: int = 1
    bc: str = "aaaa"
    # device-mesh rank geometry "gx,gy,gz,gt" (QEX -rankgeom:,
    # layoutX.nim:83); "" = single device.  Multi-GPU runs are not
    # ported yet, so the app refuses a non-empty value.
    rank_geom: str = ""
    # <action><gauge>
    gauge_act: str = "Wilson"    # Wilson | rect | adjoint
    beta: float = 5.0
    adj_fac: float = 0.0
    c1: float = -1.0 / 12.0
    # <action><smeared_gauge>
    sg_opt: bool = False
    smeared_gauge_act: str = "Wilson"
    sm_beta: float = 0.0
    sm_adj_fac: float = 0.0
    sm_c1: float = -1.0 / 12.0
    # <action><ferm>
    nf: int = 0
    mass: float = 0.1
    # <action><pv>
    num_pv: int = 0
    mass_pv: float = 0.75
    # <smearing>
    gauge_smearing: str = "none"   # "nhyp" | "none"
    matter_smearing: str = "nhyp"
    alpha_1: float = 0.4
    alpha_2: float = 0.5
    alpha_3: float = 0.5
    # <solver>
    a_tol: float = 1e-20
    a_maxits: int = 10000
    f_tol: float = 1e-12
    f_maxits: int = 10000
    # mixed-precision inner solves (bf16-link kernel iterations with
    # full-precision true-residual restarts) -- the QEX
    # SolverParams.sloppySolve knob (solverBase.nim:8-15)
    sloppy_solve: int = 0
    # re-solve each matter term per trajectory and print SOLVER lines;
    # costs one extra solve per term (default off -- unlike QEX, whose
    # check reads stats gathered during the trajectory for free)
    check_solvers: int = 0
    # <extra>
    plaq_freq: int = 1
    plaq_verbose: bool = True
    ploop_freq: int = 1
    pbp_freq: int = 0
    rev_check_freq: int = 0

    @property
    def dims(self) -> tuple[int, ...]:
        return (self.ns,) * self.num_ns + (self.nt,) * self.num_nt

    @classmethod
    def from_xml(cls, path: str) -> "HMCConfig":
        """Parse a staghmc_spv-format XML deck (tag-name parity with
        staghmc_spv_init_and_io.nim:168-270)."""
        root = ET.parse(path).getroot()
        c = cls()
        c.tau = _get(root, "hmc/tau", c.tau, float)
        c.g_steps = _get(root, "hmc/g_steps", c.g_steps, int)
        c.sg_steps = _get(root, "hmc/sg_steps", c.sg_steps, int)
        c.f_steps = _get(root, "hmc/f_steps", c.f_steps, int)
        c.pv_steps = _get(root, "hmc/pv_steps", c.pv_steps, int)
        c.gauge_int_alg = _get(root, "hmc/gauge_int_alg", c.gauge_int_alg)
        c.smeared_gauge_int_alg = _get(root, "hmc/smeared_gauge_int_alg",
                                       c.smeared_gauge_int_alg)
        c.ferm_int_alg = _get(root, "hmc/ferm_int_alg", c.ferm_int_alg)
        c.pv_int_alg = _get(root, "hmc/pv_int_alg", c.pv_int_alg)
        c.no_metropolis_until = _get(root, "hmc/no_metropolis_until",
                                     c.no_metropolis_until, int)
        c.num_trajectories = _get(root, "hmc/num_trajectories",
                                  c.num_trajectories, int)
        c.start_config = _get(root, "config_opts/start_config",
                              c.start_config, int)
        c.start = _get(root, "config_opts/start", c.start)
        c.save_freq = _get(root, "config_opts/save_freq", c.save_freq, int)
        c.save_path = _get(root, "config_opts/save_path", c.save_path)
        c.save_filename = _get(root, "config_opts/save_filename",
                               c.save_filename)
        c.rng_type = _get(root, "rng/rng_type", c.rng_type)
        c.parallel_seed = _get(root, "rng/parallel_seed", c.parallel_seed,
                               int)
        c.serial_seed = _get(root, "rng/serial_seed", c.serial_seed, int)
        c.ns = _get(root, "action/geom/Ns", c.ns, int)
        c.nt = _get(root, "action/geom/Nt", c.nt, int)
        c.num_ns = _get(root, "action/geom/num_Ns", c.num_ns, int)
        c.num_nt = _get(root, "action/geom/num_Nt", c.num_nt, int)
        c.bc = _get(root, "action/geom/bc", c.bc)
        c.rank_geom = _get(root, "action/geom/rank_geom", c.rank_geom)
        c.gauge_act = _get(root, "action/gauge/gauge_act", c.gauge_act)
        c.beta = _get(root, "action/gauge/beta", c.beta, float)
        c.adj_fac = _get(root, "action/gauge/adjoint/adj_fac", c.adj_fac,
                         float)
        c.c1 = _get(root, "action/gauge/rect/c1", c.c1, float)
        c.sg_opt = _get(root, "action/smeared_gauge/sg_opt", c.sg_opt, bool)
        c.smeared_gauge_act = _get(root,
                                   "action/smeared_gauge/smeared_gauge_act",
                                   c.smeared_gauge_act)
        c.sm_beta = _get(root, "action/smeared_gauge/sm_beta", c.sm_beta,
                         float)
        c.sm_adj_fac = _get(root,
                            "action/smeared_gauge/adjoint/sm_adj_fac",
                            c.sm_adj_fac, float)
        c.sm_c1 = _get(root, "action/smeared_gauge/rect/sm_c1", c.sm_c1,
                       float)
        c.nf = _get(root, "action/ferm/Nf", c.nf, int)
        c.mass = _get(root, "action/ferm/mass", c.mass, float)
        c.num_pv = _get(root, "action/pv/num_pv", c.num_pv, int)
        c.mass_pv = _get(root, "action/pv/mass_pv", c.mass_pv, float)
        c.gauge_smearing = _get(root, "smearing/gauge_smearing",
                                c.gauge_smearing)
        c.matter_smearing = _get(root, "smearing/matter_smearing",
                                 c.matter_smearing)
        c.alpha_1 = _get(root, "smearing/nhyp_smearing/alpha_1", c.alpha_1,
                         float)
        c.alpha_2 = _get(root, "smearing/nhyp_smearing/alpha_2", c.alpha_2,
                         float)
        c.alpha_3 = _get(root, "smearing/nhyp_smearing/alpha_3", c.alpha_3,
                         float)
        c.a_tol = _get(root, "solver/a_tol", c.a_tol, float)
        c.a_maxits = _get(root, "solver/a_maxits", c.a_maxits, int)
        c.f_tol = _get(root, "solver/f_tol", c.f_tol, float)
        c.f_maxits = _get(root, "solver/f_maxits", c.f_maxits, int)
        c.check_solvers = _get(root, "solver/check_solvers",
                               c.check_solvers, int)
        c.sloppy_solve = _get(root, "solver/sloppy_solve",
                              c.sloppy_solve, int)
        c.plaq_freq = _get(root, "extra/basic_meas/plaq/plaq_freq",
                           c.plaq_freq, int)
        c.plaq_verbose = _get(root, "extra/basic_meas/plaq/plaq_verbose",
                              c.plaq_verbose, bool)
        c.ploop_freq = _get(root, "extra/basic_meas/ploop_freq",
                            c.ploop_freq, int)
        c.rev_check_freq = _get(root, "extra/hmc_checks/rev_check_freq",
                                c.rev_check_freq, int)
        return c

    @classmethod
    def from_json(cls, path: str) -> "HMCConfig":
        """JSON deck (mcmc-framework style): flat key/value overriding
        the defaults (hamiltonianMonteCarlo.nim:84-131 schema spirit)."""
        with open(path) as f:
            data = json.load(f)
        c = cls()
        for k, v in data.items():
            if not hasattr(c, k):
                raise KeyError(f"unknown config key {k!r}")
            setattr(c, k, type(getattr(c, k))(v))
        return c

    def override(self, kvs: dict[str, Any]) -> "HMCConfig":
        """Apply -key=value CLI overrides (base/params.nim parity)."""
        for k, v in kvs.items():
            if not hasattr(self, k):
                raise KeyError(f"unknown config key {k!r}")
            cur = getattr(self, k)
            setattr(self, k, type(cur)(v) if cur is not None else v)
        return self


@dataclasses.dataclass
class FlowConfig:
    """Schema of the gauge_flow XML deck (src/flow/input_gf.xml)."""

    flow_act: str = "Wilson"       # Wilson | Rect | Adj
    ns: int = 8
    nt: int = 8
    t_max: float = 1.0
    segments: list = dataclasses.field(
        default_factory=lambda: [(1.0, 0.02)])
    beta: float = 5.0
    c1: float = -1.0 / 12.0
    adj_plaq: float = 0.0
    start: str = "hot"
    seed: int = 987654321

    @property
    def dims(self) -> tuple[int, ...]:
        return (self.ns, self.ns, self.ns, self.nt)

    @classmethod
    def from_xml(cls, path: str) -> "FlowConfig":
        root = ET.parse(path).getroot()
        c = cls()
        c.flow_act = _get(root, "action/flow_act", c.flow_act)
        c.ns = _get(root, "action/geom/Ns", c.ns, int)
        c.nt = _get(root, "action/geom/Nt", c.nt, int)
        c.t_max = _get(root, "flow_prms/global_params/t_max", c.t_max,
                       float)
        nloops = _get(root, "flow_prms/global_params/f_munu_loop", 1, int)
        segs = []
        sp = root.find("flow_prms/specific_params")
        if sp is not None:
            times, dts = {}, {}
            for el in sp:
                if el.tag.startswith("time"):
                    times[int(el.tag[4:])] = float(el.text)
                elif el.tag.startswith("dt"):
                    dts[int(el.tag[2:])] = float(el.text)
            for i in sorted(times):
                segs.append((times[i], dts.get(i, 0.02)))
        c.segments = segs or [(c.t_max, 0.02)]
        if c.flow_act == "Wilson":
            c.beta = _get(root, "action_params/Wilson/beta_w", c.beta,
                          float)
        elif c.flow_act == "Rect":
            c.beta = _get(root, "action_params/Rect/beta_r", c.beta, float)
            c.c1 = _get(root, "action_params/Rect/c1", c.c1, float)
        elif c.flow_act == "Adj":
            c.beta = _get(root, "action_params/Adj/beta_a", c.beta, float)
            c.adj_plaq = _get(root, "action_params/Adj/adj_plaq",
                              c.adj_plaq, float)
        return c
