"""Chain agreement: the staghmc_spv app's per-trajectory lines read as
series, their blocked statistics, and the gates that hold one Markov
chain against a reference chain of the same deck.  Host-side Python on
the printed numbers; the chains share no random numbers, so agreement
is statistical only.

The condensate is compared per Z_3 sector of the Polyakov loop.  On a
small box the chain dwells in one sector for ~100 trajectories, and the
condensate differs between the real sector and the two complex ones (the
loop's phase shifts the fermions' temporal boundary condition), so its
plain mean decorrelates only as fast as the sectors.  Within a sector
it decorrelates in a few trajectories.  The two complex sectors are
charge conjugates with the same condensate, so they are pooled.  Each
class's mean is a ratio of block means (the condensate on that class's
trajectories over their count), jackknifed over blocks of the whole
chain."""

from __future__ import annotations

import math
import re

import numpy as np

from . import resample

MIN_BLOCKS = 20        # blocks of the chain under test
Z_MAX = 3.0            # combined blocked-jackknife errors
MIN_ACCEPTANCE = 0.5
# the series whose tau_int sets the block: the plaquette and exp(-dH);
# the condensate's classes take blocks of their own (chain_stats)
GATED = ("plaq", "exp_minus_dH")
CLASSES = {"pbp_real": True, "pbp_complex": False}

_ACC = re.compile(r"^(ACCEPT|REJECT): dH (\S+) \(.*\)( \[warmup\])?$")


def parse_app_lines(lines) -> dict:
    """The series of the app's ``ACCEPT``/``REJECT: dH``, ``MEASplaq``,
    ``MEASploop`` and ``MEASpbp`` lines: the measured trajectories' dH,
    accepted, plaq, ploop_re, ploop_im and pbp, and the warm-up's dH and
    plaq under ``warmup``."""
    out = {"warmup": {"dH": [], "plaq": []}, "dH": [], "accepted": [],
           "plaq": [], "ploop_re": [], "ploop_im": [], "pbp": []}
    cur = None
    for ln in lines:
        m = _ACC.match(ln)
        if m:
            warm = m.group(3) is not None
            cur = out["warmup"] if warm else out
            cur["dH"].append(float(m.group(2)))
            if not warm:
                out["accepted"].append(m.group(1) == "ACCEPT")
        elif ln.startswith("MEASplaq "):
            cur["plaq"].append(float(ln.split()[1]))
        elif ln.startswith("MEASploop ") and cur is out:
            re_, im = ln.split()[1:3]
            out["ploop_re"].append(float(re_))
            out["ploop_im"].append(float(im))
        elif ln.startswith("MEASpbp ") and cur is out:
            out["pbp"].append(float(ln.split()[1]))
    return out


def real_sector(ploop_re, ploop_im) -> list[bool]:
    """Whether each Polyakov loop lies in the real Z_3 sector (its phase
    within pi/3 of 0)."""
    return [abs(math.atan2(i, r)) < math.pi / 3
            for r, i in zip(ploop_re, ploop_im)]


def block_size(n: int, taus) -> int:
    """At least 2 tau_int of every series, and no smaller than a
    MIN_BLOCKS-th of the n points."""
    return max(1, math.ceil(2 * max(taus)), n // MIN_BLOCKS)


def blocked(series: dict, names, taus: dict | None = None) -> dict:
    """tau_int of each named series, one block for them all
    (:func:`block_size` of ``taus``, by default of the series' own
    tau_int), and each one's blocked-jackknife mean and error."""
    own = {k: resample.autocorrelation_time(series[k]) for k in names}
    n = len(series[names[0]])
    block = block_size(n, (taus or own).values())
    rec = {"tau_int": own, "block": block, "n_blocks": n // block}
    for k in names:
        mean, err = resample.jackknife(series[k], block=block)
        rec[k] = {"mean": mean, "err": err}
    return rec


def ratio_jackknife(num, den, block: int) -> dict:
    """sum(num) / sum(den) with its jackknife error over blocks of
    ``block`` points (a block where den is 0 adds to neither sum), and
    the number of blocks holding any of den."""
    nb = resample.blocked(num, block) * block
    db = resample.blocked(den, block) * block
    present = int(np.count_nonzero(db))
    if present < 2:
        return {"mean": math.nan, "err": math.nan, "blocks": present,
                "n": int(db.sum())}
    n = len(db)
    full = nb.sum() / db.sum()
    parts = (nb.sum() - nb) / (db.sum() - db)
    var = (n - 1) / n * np.sum((parts - parts.mean()) ** 2)
    return {"mean": float(n * full - (n - 1) * parts.mean()),
            "err": float(np.sqrt(var)), "blocks": present,
            "n": int(round(db.sum()))}


def chain_stats(chain: dict, taus: dict | None = None) -> dict:
    """A parsed chain's statistics: tau_int of plaq, exp(-dH), pbp,
    ploop_re and of the condensate within each sector class; a block of
    at least 2 tau_int of the GATED series and a ``pbp_block`` of at
    least 2 tau_int of the classes' condensate (``taus``, by default the
    chain's own; each no smaller than a MIN_BLOCKS-th of the chain);
    blocked-jackknife means of plaq, exp(-dH), pbp and ploop_re, and
    the ratio means of each class's condensate over pbp blocks."""
    s = dict(chain, exp_minus_dH=[math.exp(-max(d, -700.0))
                                  for d in chain["dH"]])
    real = real_sector(chain["ploop_re"], chain["ploop_im"])
    plain = ("plaq", "exp_minus_dH", "pbp", "ploop_re")
    own = {k: resample.autocorrelation_time(s[k]) for k in plain}
    for cls, flag in CLASSES.items():
        x = [p for p, r in zip(chain["pbp"], real) if r == flag]
        own[cls] = resample.autocorrelation_time(x) if x else 0.5
    n = len(chain["dH"])
    block = block_size(n, [(taus or own)[k] for k in GATED])
    pbp_block = block_size(n, [(taus or own)[k] for k in CLASSES])
    rec = {"tau_int": own, "block": block, "n_blocks": n // block,
           "pbp_block": pbp_block, "pbp_n_blocks": n // pbp_block,
           "real_share": sum(real) / max(1, n)}
    for k in plain:
        mean, err = resample.jackknife(s[k], block=block)
        rec[k] = {"mean": mean, "err": err}
    for cls, flag in CLASSES.items():
        rec[cls] = ratio_jackknife(
            [p if r == flag else 0.0 for p, r in zip(chain["pbp"], real)],
            [1.0 if r == flag else 0.0 for r in real], pbp_block)
    return rec


def z_score(a: dict, b: dict) -> float:
    """|mean_a - mean_b| over the combined error."""
    return abs(a["mean"] - b["mean"]) / math.hypot(a["err"], b["err"])


def gate(chain: dict, ref_stats: dict) -> dict:
    """Hold a parsed chain against a reference chain's
    :func:`chain_stats`: plaquette mean within Z_MAX combined errors,
    the condensate of each sector class that both chains hold in at
    least half of their pbp blocks within Z_MAX combined errors (at
    least one class so held), Creutz's <exp(-dH)> within Z_MAX errors
    of 1, acceptance at least MIN_ACCEPTANCE, at least MIN_BLOCKS
    blocks, every number finite.

    The blocks are at least 2 tau_int of the reference: both chains run
    the same deck with the same algorithm, so they share their
    autocorrelations, and the longer reference estimates them better
    (on a chain of ~100 points the estimate scatters by tens of
    percent).  The chain's own tau_int is returned beside them.  The
    condensate's blocks are the longer ones its own tau_int asks for,
    and may be fewer than MIN_BLOCKS: a chain short enough for the
    plaquette's 20 blocks holds ~10 of them.  Returns the statistics
    with ``failures``, the gates that failed (empty when all pass)."""
    st = chain_stats(chain, ref_stats["tau_int"])
    acc = sum(chain["accepted"]) / max(1, len(chain["accepted"]))
    z_plaq = z_score(st["plaq"], ref_stats["plaq"])
    z_creutz = (abs(st["exp_minus_dH"]["mean"] - 1.0)
                / st["exp_minus_dH"]["err"])
    z_pbp = {cls: z_score(st[cls], ref_stats[cls]) for cls in CLASSES
             if 2 * st[cls]["blocks"] >= st["pbp_n_blocks"]
             and 2 * ref_stats[cls]["blocks"] >= ref_stats["pbp_n_blocks"]}
    numbers = [x for k in ("dH", "plaq", "ploop_re", "ploop_im", "pbp")
               for x in chain[k]]
    failures = []
    if not all(math.isfinite(x) for x in numbers) or not numbers:
        failures.append("a non-finite or missing number")
    if len({len(chain[k]) for k in ("dH", "plaq", "pbp", "ploop_re")}) != 1:
        failures.append("series of unequal lengths")
    if not st["n_blocks"] >= MIN_BLOCKS:
        failures.append(f"{st['n_blocks']} blocks of {st['block']}, "
                        f"below {MIN_BLOCKS}")
    if not z_plaq <= Z_MAX:
        failures.append(f"plaquette {z_plaq:.2f} sigma from the reference")
    if not z_pbp:
        failures.append("pbp: no sector class in half the pbp blocks of "
                        "both chains")
    for cls, z in z_pbp.items():
        if not z <= Z_MAX:
            failures.append(f"{cls} {z:.2f} sigma from the reference")
    if not z_creutz <= Z_MAX:
        failures.append(f"<exp(-dH)> {z_creutz:.2f} sigma from 1")
    if not acc >= MIN_ACCEPTANCE:
        failures.append(f"acceptance {acc:.3f} below {MIN_ACCEPTANCE}")
    return dict(st, acceptance=acc, z_plaq=z_plaq, z_pbp=z_pbp,
                z_creutz=z_creutz, failures=failures)
