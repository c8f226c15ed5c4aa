"""Nothing the benchmark runs loads JAX, flax, the JAX package (top-level
name `semicp`, compared whole: the port is `semicp_torch`) or the
repository's tests; the yardstick loads nothing of the system."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MODULES = sorted(p.stem for p in BENCH.glob("*.py") if p.stem not in ("__init__", "run",
                                                                         "control"))
YARDSTICK = ["geom", "judge", "pgo_reference", "records", "reference", "roofline", "scenes",
             "spec"]

PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def loaded(body: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


FORBIDDEN = {"jax", "jaxlib", "flax", "semicp", "tests"}


@pytest.mark.parametrize("mod", MODULES)
def test_module_loads_nothing_forbidden(mod):
    assert not loaded(f"import benchmark.{mod}") & FORBIDDEN


@pytest.mark.parametrize("mod", YARDSTICK)
def test_yardstick_loads_nothing_of_the_system(mod):
    assert "semicp_torch" not in loaded(f"import benchmark.{mod}")


def test_metric_readers_load_nothing_of_the_system():
    body = ("from benchmark import spec\n"
            "b = spec.load_benchmark()\n"
            "[spec.metric_reader(m['name']) for m in b['per_layer'] + b['end_to_end']]")
    assert "semicp_torch" not in loaded(body)


def test_checks_load_nothing_of_the_system():
    body = ("from benchmark import spec\n"
            "[spec.check_reader(p.stem) for p in (spec.HERE / 'checks').glob('*.py')]")
    assert not loaded(body) & (FORBIDDEN | {"semicp_torch"})


def test_whole_run_loads_nothing_forbidden():
    """A whole run of a cell, cut to a CPU size, in a fresh process: what it
    loaded by the end, as run.py's own check sees it."""
    body = f"""
import importlib.util, torch
torch.set_num_threads(2)
sys.path.insert(0, {str(BENCH / 'tests')!r})
from conftest import shrink
from benchmark import spec
s = importlib.util.spec_from_file_location("run_script", {str(BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(s); s.loader.exec_module(run)
res = run.run(shrink(spec.load_cell("odom.seq-replay")), 3, 0.1, False, "cpu")
assert res["correct"], res
assert run.forbidden_modules() == [], run.forbidden_modules()
"""
    tops = loaded(body)
    assert "semicp_torch" in tops and not tops & {"jax", "jaxlib", "flax", "semicp"}
