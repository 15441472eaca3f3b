"""The port stands alone: no file of pillars_torch/ (the serving, data,
eval and CLI modules included) or chip_smoke.py imports JAX, flax, optax or
the JAX package, the package imports and reads the trained checkpoint into the dense-cell and the point-major network in a
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
import pillars_torch.cli, pillars_torch.infer, pillars_torch.native
import pillars_torch.data.stream, pillars_torch.data.pipeline
import pillars_torch.data.synthetic, pillars_torch.data.kitti_infos
import pillars_torch.train.trainer, pillars_torch.eval.kitti_ap
import pillars_torch.eval.proxies, pillars_torch.viz
import pillars_torch.geometry.rotated_iou, pillars_torch.utils.profiling
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


def test_every_port_module_is_checked():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for must in ("pillars_torch/cli.py", "pillars_torch/infer.py",
                 "pillars_torch/data/stream.py",
                 "pillars_torch/train/trainer.py",
                 "pillars_torch/eval/kitti_ap.py",
                 "pillars_torch/native/__init__.py",
                 "pillars_torch/viz/publisher.py", "chip_smoke.py"):
        assert must in names, must


def test_cli_runs_where_jax_cannot_import(tmp_path):
    """``synth-data`` and a CPU ``evaluate`` through the CLI in a process
    where JAX and the JAX package cannot be imported."""
    script = _BLOCKED_RUN.split("import pillars_torch.models.detector")[0] + (
        "from pillars_torch.cli import main\n"
        "main(['synth-data', '--root', sys.argv[1], '--num-train', '1',"
        " '--num-test', '2'])\n"
        "main(['evaluate', '--device', 'cpu', '--checkpoint', sys.argv[2],"
        " '--set', 'eval_input.dataset_root=' + sys.argv[1],"
        " 'eval_input.info_path=' + sys.argv[1] + '/kitti_infos_val.pkl',"
        " 'eval_input.num_workers=0'])\n"
        "loaded = sorted(m for m in sys.modules"
        " if m.split('.')[0] in FORBIDDEN)\n"
        "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", script.format(forbidden=FORBIDDEN),
         str(tmp_path / "d"), str(WEIGHTS)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "aggregate score:" in out.stdout


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
