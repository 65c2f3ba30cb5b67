"""The production app of qex_tpu_torch against qex_tpu's: the config
decks parse to the same fields, build_theory builds the same terms,
checkpoints interchange exactly both ways, and the port's app runs on
the CPU from the committed config-4 deck (cut to 4^4 by overrides),
prints the reference's tags, and repeats its chain on a resume."""

import contextlib
import io
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import ginibre
from qex_tpu.apps import staghmc_spv as japp
from qex_tpu.io import checkpoint as jckpt
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.utils.config import HMCConfig as JHMCConfig
from qex_tpu_torch.apps import staghmc_spv as app
from qex_tpu_torch.io import checkpoint as ckpt
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.utils.config import HMCConfig

DECK = str(Path(__file__).resolve().parent.parent / "qex_tpu_torch" / "apps"
           / "decks" / "config4_24.xml")
SMALL = ["-ns=4", "-nt=4", "-g_steps=2", "-f_steps=1", "-pv_steps=1",
         "-tau=0.2"]
OVERRIDES = {"ns": "8", "nt": "16", "tau": "0.75", "sloppy_solve": "1",
             "gauge_int_alg": "LF", "sg_opt": "1", "sm_beta": "0.5",
             "check_solvers": "1", "alpha_1": "0.3", "bc": "aaaa",
             "start": "hot", "save_filename": "x"}


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_config_matches_reference_on_the_deck():
    cfg, ref = HMCConfig.from_xml(DECK), JHMCConfig.from_xml(DECK)
    assert _fields(cfg) == _fields(ref)
    assert cfg.dims == ref.dims == (24, 24, 24, 24)
    assert (cfg.beta, cfg.nf, cfg.mass, cfg.num_pv, cfg.mass_pv) == \
        (7.0, 4, 0.05, 1, 0.5)
    assert (cfg.g_steps, cfg.f_steps, cfg.pv_steps, cfg.tau, cfg.bc) == \
        (12, 6, 6, 0.5, "pppa")
    assert (cfg.a_tol, cfg.f_tol, cfg.a_maxits, cfg.start) == \
        (1e-10, 1e-8, 1500, "cold")


def test_config_overrides_and_json_match_reference(tmp_path):
    cfg = HMCConfig.from_xml(DECK).override(dict(OVERRIDES))
    ref = JHMCConfig.from_xml(DECK).override(dict(OVERRIDES))
    assert _fields(cfg) == _fields(ref)
    assert cfg.dims == ref.dims == (8, 8, 8, 16)
    deck = tmp_path / "deck.json"
    deck.write_text('{"ns": 6, "mass": 0.2, "sloppy_solve": 1}')
    assert _fields(HMCConfig.from_json(str(deck))) == \
        _fields(JHMCConfig.from_json(str(deck)))
    with pytest.raises(KeyError):
        HMCConfig().override({"no_such_key": "1"})


@pytest.mark.parametrize("overrides", [{}, OVERRIDES])
def test_build_theory_matches_reference(overrides):
    cfg = HMCConfig.from_xml(DECK).override(dict(overrides, ns="4", nt="4"))
    jcfg = JHMCConfig.from_xml(DECK).override(dict(overrides, ns="4",
                                                   nt="4"))
    th = app.build_theory(cfg, Lattice(cfg.dims))
    ref = japp.build_theory(jcfg, JLattice(jcfg.dims), jnp.complex128)
    assert ([(x.name, x.steps, x.scheme, x.smeared) for x in th.terms]
            == [(x.name, x.steps, x.scheme, x.smeared) for x in ref.terms])
    for got, want in ((th.solver_params, ref.solver_params),
                      (th.force_solver_params, ref.force_solver_params)):
        assert (got.r2req, got.maxits, got.restarts, got.sloppy) == \
            (want.r2req, want.maxits, want.restarts, want.sloppy)
    sm, jsm = th.smear_coefs, ref.smear_coefs
    assert (sm.alpha1, sm.alpha2, sm.alpha3) == \
        (jsm.alpha1, jsm.alpha2, jsm.alpha3)
    assert (th.tau, th.bc) == (ref.tau, ref.bc)


def test_checkpoints_interchange_exactly(tmp_path):
    lat = Lattice((4, 4, 4, 4))
    u = ginibre(np.random.default_rng(3), lat.gauge_shape())
    state = {"serial_seed": 5, "parallel_seed": 6, "n_acc": 7}
    ckpt.save_checkpoint(str(tmp_path / "port"), torch.from_numpy(u),
                         state, 3)
    g, st, traj = jckpt.load_checkpoint(str(tmp_path / "port"),
                                        JLattice(lat.dims), jnp.complex128)
    assert np.array_equal(np.asarray(g), u) and (st, traj) == (state, 3)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jnp.asarray(u), state, 4)
    g, st, traj = ckpt.load_checkpoint(str(tmp_path / "jax"), lat,
                                       torch.complex128, "cpu")
    assert np.array_equal(g.numpy(), u) and (st, traj) == (state, 4)
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(str(tmp_path / "jax"), Lattice((4, 4, 4, 6)),
                             torch.complex128, "cpu")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert app.main(argv) == 0
    return out.getvalue().splitlines()


def _tagged(lines, tag):
    return [ln for ln in lines if ln.startswith(tag)]


def test_app_runs_on_the_cpu_and_resumes(tmp_path):
    base = ["--xml", DECK, "--cpu", *SMALL, "-sloppy_solve=1",
            f"-save_path={tmp_path}"]
    lines = _run(base + ["--ntraj", "2", "-save_freq=1", "-check_solvers=1",
                         "-rev_check_freq=2"])
    for tag in ("Begin H", "End H", "MEASplaq ", "MEASplaq6", "MEASploop",
                "SOLVER", "REVCHECK", "Reversed H"):
        assert _tagged(lines, tag), tag
    assert len(_tagged(lines, "ACCEPT") + _tagged(lines, "REJECT")) == 2
    assert os.path.exists(tmp_path / "config4_24_1.npz")
    dh = [float(ln.split()[2]) for ln in lines
          if ln.startswith(("ACCEPT", "REJECT"))]
    assert np.isfinite(dh).all()
    for solver in _tagged(lines, "SOLVER"):
        assert float(solver.split()[-1]) <= 10 * 1e-10
    resumed = _run(base + ["--ntraj", "1", "-start_config=1"])
    assert _tagged(resumed, "# resumed")
    assert _tagged(resumed, "Begin H") == _tagged(lines, "Begin H")[1:]
    assert _tagged(resumed, "MEASplaq ") == _tagged(lines, "MEASplaq ")[1:]


@pytest.mark.parametrize("argv,item", [
    (["-rank_geom=1,1,1,2"], "A11"), (["-pbp_freq=1"], "A9"),
    (["-nf=2"], "A6"), (["-ferm_int_alg=FGI"], "A4"),
    (["-gauge_act=rect"], "A4"), (["--profile"], "split-step"),
])
def test_unported_app_options_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        app.main(["--xml", DECK, "--cpu", "--ntraj", "0", *SMALL, *argv])


def test_app_needs_a_card_or_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the app would run on it")
    assert app.main(["--xml", DECK, "--ntraj", "0"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_md_precision_tool(capsys):
    """The float32-rounding yardstick runs on the host and reports a
    small deviation on a smooth 4^4 start; without --cpu it refuses."""
    import json

    from qex_tpu_torch.apps import md_precision
    assert md_precision.main(["--start", "0.3"]) == 2
    capsys.readouterr()
    assert md_precision.main(["--cpu", "--start", "0.3", *SMALL]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["dims"] == [4, 4, 4, 4] and res["smeared"]
    assert 0 < res["max_link_dev"] < 1e-4
    assert res["abs_ddH"] < 1e-4 * abs(res["h_old"])
