"""The staggered Dslash generation benchmark on one CUDA card (port of
the ``main()``s of ``bench_pallas2.py``, ``bench_pallas3.py``,
``exp_s8.py``, ``exp_vpu.py`` and ``exp_pallas3.py``).

    python -m qex_tpu_torch.bench.stag_generations [--lattice 32 32 32 32]
        [--kind v1|v2|v3|v4|s8|split|all] [--bf16] [--compute-only]
        [--mode dma|matvec|shifts|compute|full] [--iters 50]

Builds expm(0.7 tah) links and a seeded spinor on the card, checks each
generation's hop against the fast-layout operator ``dslash_fast`` (the
split modes and ``compute_only`` against their plain twins), cross-checks
the 8-term hop (s8) against the reference generation that ``fits``
picks (v3 where the JAX v3 kernel fits, else v1, as ``exp_s8.py``
does), and times each one by the scripts' chain: pairs of hops onto
parity 1 and back to 0, the vector renormalised after each pair, the
chain replayed from a CUDA graph as the scripts jit it.  It
prints one JSON line per instance.  Kinds: v1 (``stag_pallas``), v2
(``stag_pallas2``), v3 (``stag_pallas3``), v4 (``stag_pallas4``), s8
(the 8-term kernel of ``stag_hisq``) and split (the v3 split modes of
``bench.exp_pallas3``); ``all`` runs every kind with float32 and
bfloat16 links where it has both, v4 also with ``compute_only``, and
split in all five modes.  It measures and adds no physics.  It needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..device import resolve
from ..lattice import Lattice
from ..ops import group, linalg
from ..physics import stag_fast as sf
from ..physics import stag_hisq as sh
from ..physics import stag_pallas as sp1
from ..physics import stag_pallas2 as sp2
from ..physics import stag_pallas3 as sp3
from ..physics import stag_pallas4 as sp4
from ..physics import staggered as st
from . import exp_pallas3 as ep3

KINDS = ("v1", "v2", "v3", "v4", "s8", "split")
FLOPS_PER_SITE = 594          # staggered.dslash_flops_per_site(4, 3)


@dataclasses.dataclass(frozen=True)
class Instance:
    """One kernel instance: a generation, its link type and, for v4 and
    the split kind, its switch or mode."""

    kind: str
    links_dtype: torch.dtype = torch.float32
    compute_only: bool = False
    mode: str | None = None

    @property
    def label(self) -> str:
        tag = self.kind + ("-bf16" if self.links_dtype == torch.bfloat16
                           else "")
        if self.compute_only:
            tag += "-co"
        return tag + (f"-{self.mode}" if self.mode else "")


def all_instances() -> list[Instance]:
    bf = torch.bfloat16
    out = [Instance("v1"), Instance("v1", bf), Instance("v2"),
           Instance("v3"), Instance("v3", bf), Instance("v4"),
           Instance("v4", bf), Instance("v4", compute_only=True),
           Instance("v4", bf, compute_only=True), Instance("s8"),
           Instance("s8", bf)]
    return out + [Instance("split", mode=m) for m in ep3.MODES]


def bytes_per_site(inst: Instance) -> int:
    """Bytes an output site must move (each input read once, the output
    written once): links (72 B per term in float32, 36 B in bfloat16),
    the spinor in (24 B) and out (24 B)."""
    term = 36 if inst.links_dtype == torch.bfloat16 else 72
    if inst.kind == "split":
        return {"dma": 8 * term + 24, "matvec": term + 48,
                "shifts": 48, "compute": term + 48,
                "full": 8 * term + 48}[inst.mode]
    return (term if inst.compute_only else 8 * term) + 48


def flops_per_site(inst: Instance) -> int:
    """The staggered model's 594 flop/site, or the 8 x 6 adds of the
    split modes that do no matvec."""
    return 48 if inst.mode in ("dma", "shifts") else FLOPS_PER_SITE


def setup(lat: Lattice, seed: int = 7,
          device: torch.device | str | None = None):
    """(FastStagEO of expm(0.7 tah) links, complex64 fast-layout spinor
    (3, Th, Z, Y*X) of unit norm) from ``seed``, on ``device`` (default:
    the CUDA card; raises without one)."""
    device = resolve(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, lat.nc, torch.complex64)) for _ in range(lat.nd)])
    s = sf.new_fast(st.new_stag_eo(lat, u))
    X, Y, Z, T = lat.dims
    x = torch.randn((3, T // 2, Z, Y * X), generator=gen,
                    dtype=torch.float32, device=device)
    x = (x / torch.sqrt(linalg.norm2(x))).to(torch.complex64)
    return s, x


def build(inst: Instance, s: sf.FastStagEO):
    """The kernel-ready operator of ``inst`` on s's device."""
    dev, ldt = s.g_e.device, inst.links_dtype
    if inst.kind == "v1":
        return sp1.new_pallas(s, ldt, device=dev)
    if inst.kind == "v2":
        if ldt != torch.float32:
            raise ValueError("v2 has float32 links only")
        return sp2.new_pallas2(s, device=dev)
    if inst.kind == "s8":
        return sh.new_stag8(s, links_dtype=ldt)
    if inst.kind == "split" and ldt != torch.float32:
        raise ValueError("the split modes take float32 links only")
    return sp3.new_pallas3(s, ldt, device=dev)


def to_layout(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Complex fast-layout x -> the vector layout of ``kind``."""
    if kind == "s8":
        return x
    xs = sp1._split(x)
    return sp2.to_gridmajor_spinor(xs) if kind == "v2" else xs


def from_layout(kind: str, v: torch.Tensor) -> torch.Tensor:
    """The vector layout of ``kind`` -> complex fast layout."""
    if kind == "s8":
        return v
    return sp1._join(sp2.from_gridmajor_spinor(v) if kind == "v2" else v)


def hop(inst: Instance, op):
    """(v, parity_out) -> the hop of ``inst`` on its own vector layout."""
    k = inst.kind
    if k == "v1":
        return lambda v, p: sp1.dslash_pallas(op, v, p)
    if k == "v2":
        return lambda v, p: sp2.dslash_pallas2(op, v, p)
    if k == "v3":
        return lambda v, p: sp3.dslash_pallas3(op, v, p)
    if k == "v4":
        return lambda v, p: sp4.dslash_pallas4(op, v, p, inst.compute_only)
    if k == "s8":
        return lambda v, p: sh.dslash_stag8(op, v, p)
    return lambda v, p: ep3.run(op.l_e if p == 0 else op.l_o, v, op.lat, p,
                                inst.mode)


def plain_hop(inst: Instance, op):
    """(v, parity_out) -> the plain twin of ``inst``'s hop."""
    k = inst.kind
    if k == "v1":
        return lambda v, p: sp1.dslash_pallas_plain(op, v, p)
    if k == "v2":
        return lambda v, p: sp2.dslash_pallas2_plain(op, v, p)
    if k == "v3":
        return lambda v, p: sp3.dslash_pallas3_plain(op, v, p)
    if k == "v4":
        return lambda v, p: sp4.dslash_pallas4_plain(op, v, p,
                                                     inst.compute_only)
    if k == "s8":
        return lambda v, p: sh.dslash_stag8_plain(op, v, p)
    return lambda v, p: ep3.run_plain(op.l_e if p == 0 else op.l_o, v,
                                      op.lat, p, inst.mode)


def d2ee(kind: str, op):
    """(v, m) -> (m^2 - D_eo D_oe) v of a generation's operator (the
    operator a CG applies)."""
    return {"v1": lambda v, m: sp1.d2ee_pallas(op, v, m),
            "v2": lambda v, m: sp2.d2ee_pallas2(op, v, m),
            "v3": lambda v, m: sp3.d2ee_pallas3(op, v, m),
            "v4": lambda v, m: sp4.d2ee_pallas4(op, v, m),
            "s8": lambda v, m: sh.d2ee_stag8(op, v, m)}[kind]


def rel2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Squared relative deviation |got - ref|^2 / |ref|^2."""
    return float(linalg.norm2(got - ref, torch.float64)
                 / linalg.norm2(ref, torch.float64))


def deviation(inst: Instance, op, v: torch.Tensor, parity_out: int,
              got: torch.Tensor, ref: torch.Tensor) -> float:
    """Squared relative deviation of a hop ``got`` from ``ref``; for the
    matvec mode, whose terms cancel, relative to the squared norm of its
    eight halved terms."""
    if inst.mode != "matvec":
        return rel2(got, ref)
    terms = ep3.terms_plain(op.l_e if parity_out == 0 else op.l_o, v,
                            op.lat, parity_out, "matvec")
    return float(linalg.norm2(got - ref, torch.float64)
                 / linalg.norm2(0.5 * terms, torch.float64))


def check(inst: Instance, op, s: sf.FastStagEO, x: torch.Tensor) -> float:
    """Squared relative deviation of one hop onto parity 1 from
    ``dslash_fast`` on the same links (``bench_pallas3.py``'s on-chip
    check); the split modes and ``compute_only``, which compute other
    functions, against their plain twins."""
    v = to_layout(inst.kind, x)
    got = hop(inst, op)(v, 1)
    if inst.kind == "split" or inst.compute_only:
        return deviation(inst, op, v, 1, got, plain_hop(inst, op)(v, 1))
    return rel2(from_layout(inst.kind, got), sf.dslash_fast(s, x, 1))


def chain_ms(fn, v: torch.Tensor, iters: int) -> float:
    """Milliseconds per hop of the scripts' chain: ``iters // 2`` pairs
    of hops onto parity 1 and back to 0, each pair renormalised.  The
    scripts time one jitted scan of the chain; here the chain is
    captured once in a CUDA graph (so no host work lies between its
    launches) and one replay is timed by CUDA events after a warm
    one."""
    def chain(w):
        for _ in range(iters // 2):
            w = fn(fn(w, 1), 0)
            w = w / torch.sqrt(linalg.norm2(w))
        return w

    chain(v)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(v)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (2 * (iters // 2))


def ab(lat: Lattice, instances: list[Instance], iters: int = 50,
       seed: int = 7, device: torch.device | str | None = None,
       emit=print) -> list[dict]:
    """Check and time each instance on one set of links; cross-check s8
    against the reference generation (``exp_s8.py``: squared deviation
    below 1e-10, else AssertionError).  Returns one record per
    instance (and emits each as a JSON line)."""
    s, x = setup(lat, seed, device)
    sites = lat.volume // 2
    ref_kind = "v3" if sp3.fits(lat) else "v1"
    ref_op = build(Instance(ref_kind), s)
    a = from_layout(ref_kind, hop(Instance(ref_kind), ref_op)(
        to_layout(ref_kind, x), 0))
    b = sh.dslash_stag8(sh.new_stag8(s), x, 0)
    cross = rel2(b, a)
    emit(json.dumps({"s8_vs_ref": ref_kind, "rel_dev2": cross}))
    if not cross < 1e-10:
        raise AssertionError(f"s8 against {ref_kind}: {cross}")
    del ref_op
    records = []
    for inst in instances:
        op = build(inst, s)
        dev = check(inst, op, s, x)
        ms = chain_ms(hop(inst, op), to_layout(inst.kind, x), iters)
        nbytes = bytes_per_site(inst) * sites
        rec = {"instance": inst.label, "dims": list(lat.dims),
               "rel_dev2": dev, "ms_per_hop": ms,
               "gflops": flops_per_site(inst) * sites / (ms * 1e-3) / 1e9,
               "bytes_per_site": bytes_per_site(inst),
               "gbs": nbytes / (ms * 1e-3) / 1e9}
        emit(json.dumps(rec))
        records.append(rec)
        del op
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qex_tpu_torch.bench.stag_generations",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--lattice", type=int, nargs=4,
                    default=[32, 32, 32, 32], metavar=("X", "Y", "Z", "T"))
    ap.add_argument("--kind", choices=KINDS + ("all",), default="all")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 links (v1, v3, v4, s8)")
    ap.add_argument("--compute-only", action="store_true",
                    help="v4: term 0's links in every term")
    ap.add_argument("--mode", choices=ep3.MODES, default="full",
                    help="the split kind's mode")
    ap.add_argument("--iters", type=int, default=50,
                    help="hops per timed chain")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stag_generations: no CUDA device", file=sys.stderr)
        return 2
    if args.kind == "all":
        instances = all_instances()
    else:
        instances = [Instance(
            args.kind, torch.bfloat16 if args.bf16 else torch.float32,
            args.compute_only and args.kind == "v4",
            args.mode if args.kind == "split" else None)]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "lattice": args.lattice}), flush=True)
    ab(Lattice(args.lattice), instances, args.iters,
       emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
