"""The port stands alone: no file of pillars_torch/ or chip_smoke.py imports
JAX, flax, optax or the JAX package, the package imports and reads the
trained checkpoint into the dense-cell and the point-major network in a
process where those cannot be imported, and its config copy equals the JAX
package's."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pillars_tpu"}
WEIGHTS = ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl"


def _port_files():
    return sorted((ROOT / "pillars_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


_BLOCKED_RUN = """
import importlib.abc, sys
FORBIDDEN = {forbidden!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked " + name)
        return None
sys.meta_path.insert(0, Block())
import pillars_torch.models.detector, pillars_torch.ops.nms_cuda
import pillars_torch.ops.rpn_cuda
from pillars_torch.config import Config
from pillars_torch.weights import from_jax_variables, load_params
params, stats = load_params(sys.argv[1])
state = from_jax_variables(params, stats, Config.default())
point_major = (Config.default().override("model.pfn.dense_cell", False)
               .override("model.rpn.use_pallas_blocks", True))
assert from_jax_variables(params, stats, point_major).keys() == state.keys()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not loaded, loaded
print(len(state))
"""


def test_weights_load_where_jax_cannot_import():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(forbidden=FORBIDDEN),
         str(WEIGHTS)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 100


@pytest.mark.parametrize("yaml_name", [None, "pedestrian_d435i.yaml",
                                       "kitti_3class.yaml",
                                       "second_sparse_d435i.yaml"])
def test_config_equals_jax_config(yaml_name):
    from pillars_torch.config import Config as TorchConfig
    from pillars_tpu.config import Config as JaxConfig

    if yaml_name is None:
        tc, jc = TorchConfig.default(), JaxConfig.default()
    else:
        path = str(ROOT / "configs" / yaml_name)
        tc, jc = TorchConfig.from_yaml(path), JaxConfig.from_yaml(path)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.model.voxel.grid_size == jc.model.voxel.grid_size
    assert tc.model.feature_map_size == jc.model.feature_map_size
    assert tc.model.num_anchors == jc.model.num_anchors
