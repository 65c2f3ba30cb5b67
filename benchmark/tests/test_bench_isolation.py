"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module name; the reference imports nothing of the
program either."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "qex_tpu"}


def imported_top_names(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        names = imported_top_names(path)
        assert "qex_tpu_torch" not in names and not names & FORBIDDEN, path


def test_whole_top_level_names():
    mods = ["qex_tpu_torch", "qex_tpu_torch.ops", "torch", "jaxtyping"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["qex_tpu.ops", "jax"]) == [
        "jax", "qex_tpu.ops"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, {root!r}); import io; "
            "from benchmark import harness; "
            "out = io.StringIO(); "
            "rc = harness.main(['--workload', 'spv.solve32x64', '--seed', "
            "'5', '--seconds', '0.2', '--trace', '0'], device='cpu', "
            "dims=(4, 4, 4, 4), out=out, err=io.StringIO()); "
            "print(rc, harness.forbidden_modules())"
            ).format(root=str(harness.ROOT))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "0 []"
