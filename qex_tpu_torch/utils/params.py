"""QEX-style command-line parameter system (copy of
``qex_tpu.utils.params``; :func:`default_setup` returns a torch tensor).

The reference's src/base/params.nim (497 LoC):
``-key:value`` CLI flags with a registered default + doc string per
parameter, ``-loadParams:file`` indirection, used/unused tracking, and
a help listing -- the interface every reference example/bench program
uses (``intParam``/``floatParam``/``strParam``/``intSeqParam``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable


@dataclasses.dataclass
class _Param:
    name: str
    default: Any
    doc: str
    used: bool = False


class Params:
    """Parameter registry + CLI parser.

    >>> prm = Params(argv=["-beta:6.0", "-lat:8,8,8,8"])
    >>> beta = prm.float_param("beta", 5.5, "gauge coupling")
    >>> lat = prm.int_seq_param("lat", [4, 4, 4, 4], "lattice size")
    """

    def __init__(self, argv: list[str] | None = None):
        self._registry: dict[str, _Param] = {}
        self._cli: dict[str, str] = {}
        self.positional: list[str] = []
        argv = sys.argv[1:] if argv is None else argv
        for a in argv:
            if a.startswith("-") and ":" in a:
                k, _, v = a[1:].partition(":")
                if k == "loadParams":
                    self._load_file(v)
                else:
                    self._cli[k] = v
            else:
                self.positional.append(a)

    def _load_file(self, path: str) -> None:
        """-loadParams:file -- one '-key:value' or 'key value' per line
        (params.nim:40 parity)."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("-") and ":" in line:
                    k, _, v = line[1:].partition(":")
                elif ":" in line:
                    k, _, v = line.partition(":")
                else:
                    parts = line.split(None, 1)
                    if len(parts) != 2:
                        continue
                    k, v = parts
                self._cli.setdefault(k.strip(), v.strip())

    def _get(self, name: str, default: Any, doc: str,
             conv: Callable[[str], Any]) -> Any:
        p = self._registry.setdefault(name, _Param(name, default, doc))
        p.used = True
        if name in self._cli:
            return conv(self._cli[name])
        return default

    def int_param(self, name: str, default: int, doc: str = "") -> int:
        return self._get(name, default, doc, int)

    def float_param(self, name: str, default: float, doc: str = ""
                    ) -> float:
        return self._get(name, default, doc, float)

    def str_param(self, name: str, default: str, doc: str = "") -> str:
        return self._get(name, default, doc, str)

    def bool_param(self, name: str, default: bool, doc: str = "") -> bool:
        return self._get(name, default, doc,
                         lambda s: s.lower() in ("1", "true", "yes"))

    def int_seq_param(self, name: str, default: list[int], doc: str = ""
                      ) -> list[int]:
        return self._get(name, default, doc,
                         lambda s: [int(x) for x in s.replace(",", " ")
                                    .split()])

    def float_seq_param(self, name: str, default: list[float],
                        doc: str = "") -> list[float]:
        return self._get(name, default, doc,
                         lambda s: [float(x) for x in s.replace(",", " ")
                                    .split()])

    def unknown(self) -> list[str]:
        """CLI keys that no program parameter consumed ('unused'
        warnings of params.nim)."""
        return [k for k in self._cli if k not in self._registry]

    def help_text(self) -> str:
        lines = ["parameters (-name:value):"]
        for p in self._registry.values():
            lines.append(f"  -{p.name}:{p.default!r}  {p.doc}")
        return "\n".join(lines)

    def echo_params(self) -> None:
        for p in self._registry.values():
            val = self._cli.get(p.name, p.default)
            print(f"# param {p.name} = {val}")


def default_setup(prm: Params | None = None, device=None):
    """Lattice-size-or-gauge-file bootstrap (QEX ``defaultSetup``,
    gauge/gaugeUtils.nim:1272): returns (Lattice, gauge or None).

    Accepts ``-lat:X,Y,Z,T`` or a positional SciDAC gauge file, whose
    links land on ``device`` (default: the CUDA card) in the file's
    precision.
    """
    import re

    import torch

    from ..device import resolve
    from ..io import lime
    from ..lattice import Lattice

    prm = prm or Params()
    if prm.positional:
        fn = prm.positional[0]
        recs = {r.type: r for r in lime.read_lime(fn)}
        pf = recs.get("scidac-private-file-xml")
        m = re.search(rb"<dims>([\d ]+)</dims>", pf.data) if pf else None
        if not m:
            raise ValueError(f"cannot read lattice dims from {fn}")
        dims = tuple(int(x) for x in m.group(1).split())
        lat = Lattice(dims)
        u = torch.from_numpy(lime.load_gauge(fn, lat)).to(resolve(device))
        return lat, u
    dims = prm.int_seq_param("lat", [8, 8, 8, 8], "lattice dimensions")
    return Lattice(tuple(dims)), None
