"""No run imports JAX or the JAX package, and the reference imports nothing
of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from conftest import small

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent
BANNED_IN_REFERENCE = ("jax", "jaxlib", "flax", "parallax_tpu", "parallax_tpu_torch")


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    calls = [n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "import_module"
             and n.args and isinstance(n.args[0], ast.Constant)]
    return {n.split(".")[0] for n in names + calls}


def test_reference_imports_neither_jax_nor_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert {f.stem for f in files} >= {"threefry", "physics", "lander", "billiards", "driver",
                                       "plain"}
    for f in files:
        bad = imported_tops(f) & set(BANNED_IN_REFERENCE)
        assert not bad, f"{f} imports {bad}"


def test_benchmark_files_import_no_jax():
    for f in sorted(BENCH.rglob("*.py")):
        bad = imported_tops(f) & set(harness.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_a_run_loads_no_jax_module():
    cell = harness.cell_of(harness.load_spec(), "lunarlander.rollout")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "r = harness.run_cell('lunarlander.rollout', 5, 0.1, 1, device='cpu', overrides=%r)\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n"
    ) % (str(BENCH.parent), small(cell))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "parallax_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "parallax_tpu.probe", object())
    assert harness.forbidden_modules() == ["parallax_tpu"]
