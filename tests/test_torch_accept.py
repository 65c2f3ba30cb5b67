"""The north-star chain's deck, reference and gate: the committed deck
parses to the same fields in both packages, ACCEPT_NS_CPU.json (the JAX
app's complex128 chain, exp_accept_ns_cpu.py) belongs to that deck and
meets its own refusal rule, the port's app on the host prints the lines
that ``qex_tpu_torch.utils.chain`` reads, and the gate that
chip_smoke.py's northstar_accept applies passes a chain drawn like the
reference's and fails one shifted by 5 sigma.  No JAX trajectory runs
here."""

import contextlib
import hashlib
import io
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

from _torch_helpers import single_threaded  # noqa: F401
from qex_tpu.utils.config import HMCConfig as JHMCConfig
from qex_tpu_torch.apps import staghmc_spv as app
from qex_tpu_torch.utils import chain
from qex_tpu_torch.utils.config import HMCConfig

pytestmark = pytest.mark.usefixtures("single_threaded")

ROOT = Path(__file__).resolve().parent.parent
DECK = ROOT / "qex_tpu_torch" / "apps" / "decks" / "northstar_accept.xml"
REF = ROOT / "ACCEPT_NS_CPU.json"
N_CARD = 160          # the card's measured trajectories (chip_smoke.py)


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF.read_text())


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _close(a, b) -> bool:
    """Nested statistics equal, floats to 1e-12 relative (numpy's sums
    may round an ulp apart between two runs of the same arithmetic)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float):
        return a == pytest.approx(b, rel=1e-12, nan_ok=True)
    return a == b


def test_deck_parses_alike():
    cfg, jcfg = HMCConfig.from_xml(str(DECK)), JHMCConfig.from_xml(str(DECK))
    assert _fields(cfg) == _fields(jcfg)
    # config 4's action, unchanged
    assert (cfg.beta, cfg.nf, cfg.mass, cfg.num_pv, cfg.mass_pv, cfg.bc) \
        == (7.0, 4, 0.05, 1, 0.5, "pppa")
    assert (cfg.alpha_1, cfg.alpha_2, cfg.alpha_3, cfg.matter_smearing) \
        == (0.4, 0.5, 0.5, "nhyp")
    assert (cfg.a_tol, cfg.f_tol, cfg.sloppy_solve, cfg.save_freq) \
        == (1e-10, 1e-8, 0, 0)
    assert {cfg.gauge_int_alg, cfg.ferm_int_alg, cfg.pv_int_alg} == {"2MN"}
    assert cfg.g_steps == 2 * cfg.f_steps == 2 * cfg.pv_steps
    assert (cfg.plaq_freq, cfg.ploop_freq) == (1, 1)


def test_reference_belongs_to_the_deck(ref):
    assert ref["deck_sha256"] == hashlib.sha256(DECK.read_bytes()).hexdigest()
    cfg = HMCConfig.from_xml(str(DECK))
    assert ref["lattice"] == list(cfg.dims)
    assert (ref["tau"], ref["g_steps"], ref["f_steps"], ref["pv_steps"],
            ref["warmup"]) == (cfg.tau, cfg.g_steps, cfg.f_steps,
                               cfg.pv_steps, cfg.no_metropolis_until)
    pbp = re.search(r"<pbp_freq>\s*(\d+)\s*</pbp_freq>", DECK.read_text())
    assert ref["pbp_freq"] == int(pbp.group(1)) >= 1


def test_reference_meets_its_rule(ref):
    """Acceptance in (0.5, 0.95), at least 200 measured and 100 quenched
    trajectories, z_fermion >= 5 (the larger of the plaquette's and the
    sector classes' condensate against the quenched ensemble); its
    statistics are those the card's gate arithmetic computes from its
    series."""
    s = ref["series"]
    n = ref["n_meas"]
    assert n >= 200 and ref["quenched"]["n_meas"] >= 100
    assert {len(v) for v in s.values()} == {n}
    assert 0.5 < ref["acceptance"] < 0.95
    assert ref["acceptance"] == sum(s["accepted"]) / n
    assert ref["z_fermion"] >= 5
    assert ref["z_fermion"] == max(ref["z_fermion_by"].values())
    assert all(math.isfinite(x) for k in ("plaq", "pbp", "dH", "ploop_re")
               for x in s[k])
    st = chain.chain_stats(s)
    assert st["n_blocks"] >= chain.MIN_BLOCKS
    assert st["block"] >= 2 * max(st["tau_int"][k] for k in chain.GATED)
    assert st["pbp_block"] >= 2 * max(st["tau_int"][k]
                                      for k in chain.CLASSES)
    assert _close(st, ref["stats"])
    que = ref["quenched"]
    qst = chain.blocked(que["series"], ["plaq"])
    vst = chain.chain_stats(que["valence"])
    assert _close(qst, que["stats"]) and _close(vst, que["valence_stats"])
    z = {"plaq": chain.z_score(st["plaq"], qst["plaq"])}
    z.update({k: chain.z_score(st[k], vst[k]) for k in ref["z_fermion_by"]
              if k != "plaq"})
    assert _close(z, ref["z_fermion_by"])


def test_port_app_lines_parse():
    """The port's app on the host (complex128) on the deck cut in depth:
    finite ACCEPT/REJECT, MEASplaq, MEASploop and MEASpbp lines, read by
    the parser of the card's phase."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = app.main(["--xml", str(DECK), "--cpu", "--ntraj", "2",
                       "-ns=4", "-nt=4", "-g_steps=2", "-f_steps=1",
                       "-pv_steps=1", "-tau=0.2", "-no_metropolis_until=1",
                       "-pbp_freq=1"])
    assert rc == 0
    p = chain.parse_app_lines(out.getvalue().splitlines())
    assert len(p["warmup"]["dH"]) == len(p["warmup"]["plaq"]) == 1
    for k in ("dH", "accepted", "plaq", "ploop_re", "ploop_im", "pbp"):
        assert len(p[k]) == 1, k
    assert all(math.isfinite(x) for k in ("dH", "plaq", "ploop_re", "pbp")
               for x in p[k])
    assert 0 < p["plaq"][0] < 1 and p["pbp"][0] > 0


def _ar1(rng, n, mean, sd, tau):
    """A Gaussian AR(1) series of integrated autocorrelation time tau."""
    rho = (2 * tau - 1) / (2 * tau + 1)
    x = np.empty(n)
    x[0] = rng.normal()
    for i in range(1, n):
        x[i] = rho * x[i - 1] + math.sqrt(1 - rho * rho) * rng.normal()
    return mean + sd * x


def _like_reference(ref, seed):
    """N_CARD trajectories drawn like the reference chain: the first half
    in the real Z_3 sector, the second in a complex one; the plaquette
    and each sector's condensate AR(1) series with the reference's mean,
    spread and tau_int; dH Gaussian with <dH> = var/2 (so <exp(-dH)> =
    1) at its spread, and a Metropolis decision on each."""
    rng = np.random.default_rng(seed)
    s, st = ref["series"], ref["stats"]
    real = chain.real_sector(s["ploop_re"], s["ploop_im"])
    half = N_CARD // 2
    c = {"plaq": list(_ar1(rng, N_CARD, np.mean(s["plaq"]),
                           np.std(s["plaq"]), st["tau_int"]["plaq"]))}
    c["pbp"] = []
    for cls, flag in chain.CLASSES.items():
        x = [p for p, r in zip(s["pbp"], real) if r == flag]
        c["pbp"] += list(_ar1(rng, half, np.mean(x), np.std(x),
                              max(st["tau_int"][cls], 0.5)))
    c["ploop_re"] = [0.3] * half + [-0.15] * half
    c["ploop_im"] = [0.0] * half + [0.26] * half
    sd = float(np.std(s["dH"]))
    c["dH"] = list(rng.normal(sd * sd / 2, sd, N_CARD))
    c["accepted"] = [bool(rng.uniform() < math.exp(-d)) for d in c["dH"]]
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_passes_a_chain_like_the_reference(ref, seed):
    g = chain.gate(_like_reference(ref, seed), ref["stats"])
    assert g["failures"] == [] and g["n_blocks"] >= chain.MIN_BLOCKS


@pytest.mark.parametrize("key", ["plaq", "pbp"])
def test_gate_fails_a_chain_shifted_by_5_sigma(ref, key):
    """A plaquette or a condensate 5 combined errors off fails the gate,
    and only that gate (each sector class's, for the condensate)."""
    c = _like_reference(ref, 0)
    g = chain.gate(c, ref["stats"])
    names = ["plaq"] if key == "plaq" else list(chain.CLASSES)
    shift = 5 * max(math.hypot(g[k]["err"], ref["stats"][k]["err"])
                    for k in names)
    c[key] = [x + shift for x in c[key]]
    failures = chain.gate(c, ref["stats"])["failures"]
    assert len(failures) == len(names)
    assert all(f.startswith({"plaq": "plaquette"}.get(key, "pbp_"))
               for f in failures)


def test_gate_fails_a_biased_md_and_a_short_chain(ref):
    c = _like_reference(ref, 0)
    c["dH"] = [d - 0.3 for d in c["dH"]]     # <exp(-dH)> = 1.35
    assert any("exp(-dH)" in f
               for f in chain.gate(c, ref["stats"])["failures"])
    short = {k: v[:15] for k, v in _like_reference(ref, 0).items()}
    assert any("blocks" in f
               for f in chain.gate(short, ref["stats"])["failures"])
