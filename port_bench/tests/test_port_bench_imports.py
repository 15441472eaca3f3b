"""What the benchmark's processes load: nothing of JAX or of the JAX
package, and a reference that imports nothing of the program."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from port_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "port_bench" / "reference"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = set(_top_level_imports(path))
    assert not found & {"pillars_torch", *harness.FORBIDDEN}, found


def _child(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    mods = _child(
        "import json, sys\n"
        "import port_bench.reference.pointpillars, "
        "port_bench.reference.compare\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "pillars_torch" not in mods
    assert not set(mods) & set(harness.FORBIDDEN)


def test_a_whole_run_loads_no_jax():
    """A whole run on the CPU (everything but the look for a card), then
    the top-level names of every module the process holds."""
    mods = _child(
        "import json, sys, torch\n"
        "torch.set_num_threads(4)\n"
        "from port_bench import harness\n"
        "out = harness.run_cell('d435i_sensor1', 5, 1.0, False, "
        "device='cpu', traffic_overrides={'bank': 2, 'warmup': 1})\n"
        "assert out['correct'], out\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "pillars_torch" in mods
    assert not set(mods) & set(harness.FORBIDDEN), mods


def test_without_a_card_the_command_exits_non_zero_and_prints_nothing():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "d435i_sensor1", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
