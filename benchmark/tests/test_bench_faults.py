"""A whole run on the host at a tiny size (the harness's look for a card
skipped), with the timed path broken underneath: ``correct`` has to
come out false for each fault the cell can have, and true without one.
The window is 0.2 s, so the sample is drawn from its first units.  The
control (the reference in bfloat16 in the program's place) has to come
out not correct too, and so does the HMC's fault of H planted in the
reference."""

import functools
import io
import json

import pytest
import torch

from benchmark import control, harness

HMC, SOLVE, MULTI = "spv.hmc24", "spv.solve32x64", "hisq.multishift32x64"
TINY = {HMC: (4, 4, 4, 4), SOLVE: (4, 4, 4, 8), MULTI: (4, 4, 4, 8)}
FIRST = {HMC: {"sample_among_first": 1},
         SOLVE: {"sample_among_first": 2, "sample_count": 2},
         MULTI: {"sample_among_first": 2, "sample_count": 2}}


def run(cell, seed=11):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.2", "--trace", "0"], device="cpu",
                      dims=TINY[cell], out=out, err=err,
                      traffic_overrides=FIRST[cell])
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def theory_cls():
    from qex_tpu_torch.mcmc.theory import LatticeFieldTheory
    return LatticeFieldTheory


def hisq_cls():
    from qex_tpu_torch.physics.stag_hmc import HisqFermion
    return HisqFermion


def stag_solve():
    from qex_tpu_torch.physics import stag_solve as mod
    return mod


def fault_hmc_unchanged(mp):
    mp.setattr(theory_cls(), "trajectory", lambda self, u, p, phis: (u, p))


def fault_hmc_altered(mp):
    orig = theory_cls().trajectory

    def altered(self, u, p, phis):
        u1, p1 = orig(self, u, p, phis)
        u1 = u1.clone()
        u1[0, :, :, 0, 0, 0, 0] *= -1
        return u1, p1
    mp.setattr(theory_cls(), "trajectory", altered)


def fault_hmc_h_without_boson(mp):
    from qex_tpu_torch.hmc import hmc as hmc_mod

    def hamiltonian(self, u, p, phis):
        with torch.no_grad():
            h = hmc_mod.kinetic_energy(p)
            for (act, _heat), w, phi, term in zip(
                    self._at_links, self._links_per_term(u), phis,
                    self.terms):
                if not term.name.startswith("boson"):
                    h = h + act(w, phi).to(torch.float64)
        return h
    mp.setattr(theory_cls(), "hamiltonian", hamiltonian)


def fault_hmc_decision_flipped(mp):
    from qex_tpu_torch.hmc import hmc as hmc_mod
    mp.setattr(theory_cls(), "metropolis",
               staticmethod(lambda dH, r: not hmc_mod.metropolis(dH, r)))


def fault_solve_unchanged(mp):
    mod = stag_solve()
    orig = mod.solve_ee

    def zero(s, b, m, params):
        x, stats = orig(s, b, m, params)
        return torch.zeros_like(x), stats
    mp.setattr(mod, "solve_ee", zero)


def fault_solve_half(mp):
    mod = stag_solve()
    orig = mod.solve_ee

    def half(s, b, m, params):
        b = b.clone()
        b[:, b.shape[1] // 2:] = 0
        return orig(s, b, m, params)
    mp.setattr(mod, "solve_ee", half)


def fault_solve_altered(mp):
    mod = stag_solve()
    orig = mod.solve_ee

    def altered(s, b, m, params):
        x, stats = orig(s, b, m, params)
        return x * (1 + 1e-3), stats
    mp.setattr(mod, "solve_ee", altered)


def fault_multi_unchanged(mp):
    orig = hisq_cls().solve_multi

    def zero(self, u, b, masses, links=None):
        xs, stats = orig(self, u, b, masses, links=links)
        return [torch.zeros_like(x) for x in xs], stats
    mp.setattr(hisq_cls(), "solve_multi", zero)


def fault_multi_half(mp):
    orig = hisq_cls().solve_multi

    def half(self, u, b, masses, links=None):
        k = len(masses) // 2
        xs, stats = orig(self, u, b, masses[:k], links=links)
        return xs + [xs[-1]] * (len(masses) - k), stats
    mp.setattr(hisq_cls(), "solve_multi", half)


def fault_multi_altered(mp):
    orig = hisq_cls().solve_multi

    def altered(self, u, b, masses, links=None):
        xs, stats = orig(self, u, b, masses, links=links)
        return [xs[0] * (1 + 1e-3)] + xs[1:], stats
    mp.setattr(hisq_cls(), "solve_multi", altered)


@pytest.mark.parametrize("cell", [HMC, SOLVE, MULTI])
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0, res
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    (HMC, fault_hmc_unchanged), (HMC, fault_hmc_altered),
    (HMC, fault_hmc_h_without_boson), (HMC, fault_hmc_decision_flipped),
    (SOLVE, fault_solve_unchanged), (SOLVE, fault_solve_half),
    (SOLVE, fault_solve_altered),
    (MULTI, fault_multi_unchanged), (MULTI, fault_multi_half),
    (MULTI, fault_multi_altered)])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert res["correct"] is False, res


@pytest.mark.parametrize("cell,reading", [
    (HMC, "control"), (HMC, "h_without_boson"), (SOLVE, "control"),
    (MULTI, "control")])
def test_control_is_not_correct(cell, reading):
    res = control_readings(cell)
    assert res["readings"][reading]["fails"], res


@functools.lru_cache
def control_readings(cell):
    return control.run(cell, 23, "cpu", TINY[cell])


@pytest.mark.gpu
def test_solve_cell_on_card(cuda_device):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", SOLVE, "--seed", "7", "--seconds", "1",
                       "--trace", "1"], dims=(8, 8, 8, 8), out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
