"""BENCHMARK.json against the contract's shape and the files the
harness finds by name."""

import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def man():
    return harness.manifest()


def test_keys_names_and_units():
    m = man()
    assert set(m) == TOP
    assert 1 <= m["run_seconds"] <= 51
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[sec]]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for sec in ("end_to_end", "per_layer"):
        for e in m[sec]:
            assert UNIT.match(e["unit"]), e
            assert e["better"] in ("lower", "higher")
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(m)) < 64 * 1024


def test_every_file_a_cell_needs_exists():
    m = man()
    assert m["command"][1].startswith(m["paths"][0] + "/")
    cfgs = {c["name"]: c for c in m["configs"]}
    used = set()
    for w in m["workloads"]:
        cfg = cfgs[w["config"]]
        used.add(cfg["name"])
        assert (harness.ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith(m["paths"][0] + "/")
        traffic = harness.load_json(harness.BENCH / "traffic"
                                    / f"{w['traffic']}.json")
        assert (harness.BENCH / "kinds" / f"{traffic['kind']}.py").is_file()
        for k in traffic.get("kernels", []):
            assert (harness.BENCH / "kernels" / f"{k}.json").is_file()
        checks = harness.load_json(harness.BENCH / "checks"
                                   / f"{w['name']}.json")
        assert checks["limits"]
    assert used == set(cfgs)
    for e in m["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{e['name']}.py").is_file()


def test_each_per_layer_metric_moves_one_reported_end_to_end_metric():
    m = man()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for e in m["per_layer"]:
        target = e2e[e["moves"]]
        assert e["workloads"], e["name"]
        for cell in e["workloads"]:
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]
    for cell in cells:
        reported = [x["name"] for x in harness.cell_metrics(m, cell,
                                                            "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(m, cell, "per_layer")
        traffic = harness.load_json(harness.BENCH / "traffic" / (
            next(w for w in m["workloads"] if w["name"] == cell)["traffic"]
            + ".json"))
        assert traffic["rate_metric"] in reported


def test_layers_are_named_alike():
    layers = {e["layer"] for e in man()["per_layer"]}
    assert layers == {"smear", "solve", "kernel", "device"}
