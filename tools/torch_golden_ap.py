"""The accuracy anchors of the PyTorch port: KITTI AP of a trained
checkpoint on the regenerated hard validation split, through either package
on the CPU.

    python tools/torch_golden_ap.py --package jax   --root DIR [--scenes N]
                                    [--config YAML --weights PKL]
                                    [--set KEY=VALUE ...]
                                    [--write tests/golden/torch_hard_val_ap.json]
    python tools/torch_golden_ap.py --package torch --root DIR [--scenes N]
                                    [--config YAML --weights PKL]
                                    [--set KEY=VALUE ...]
                                    [--against tests/golden/torch_hard_val_ap.json]

Three goldens are kept: the d435i PointPillars model (``Config.default()``,
benchmarks/hard_synth/weights_59.pkl, the defaults here) in
tests/golden/torch_hard_val_ap.json, the same in bfloat16 (``--set
runtime.compute_dtype=bfloat16``) in tests/golden/torch_hard_val_bf16_ap.json,
and the SECOND sparse model (``--config configs/second_sparse_d435i.yaml
--weights benchmarks/second_sparse_synth/weights_33.pkl``) in
tests/golden/torch_second_sparse_val_ap.json.

``--set`` overrides config values (as the CLI's ``--set``). The JAX package
compiles with XLA's excess precision off, so that in bfloat16 XLA keeps
every rounding the package's code asks for, as the port's tests hold it
(tests/torch_parity.py); ``--xla-excess-precision`` keeps XLA's default,
which drops the rounding of a conv's output that a BatchNorm upcasts at
once. Neither matters in float32.

Regenerates the dataset of benchmarks/hard_synth/README.md (600 train / 150
val hard-profile scenes, seed 7) under ``--root`` with the chosen package's
own generator (an existing split there is reused), runs that package's
``Evaluator`` with the checkpoint, and prints one JSON object: the val
split's checksum (``pillars_torch.data.synthetic.split_checksum``, a hash
of the files, for either package), the aggregate score, the mean APs and the
AP text. One process runs one package's generator and evaluator. ``--write``
stores the result as the golden file; ``--against`` prints the distance to a
stored one.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WEIGHTS = ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl"


def load_config(cls, path, sets=()):
    cfg = cls.from_yaml(path) if path else cls.default()
    for item in sets:
        key, value = item.split("=", 1)
        cfg = cfg.override(key, _parse(value))
    return cfg


def _parse(value):
    import yaml

    return yaml.safe_load(value)


def ensure_split(synthetic, root):
    """The hard split under ``root``, generated unless it is there."""
    if not pathlib.Path(root, "kitti_infos_val.pkl").exists():
        synthetic.generate_dataset(root, num_train=600, num_test=150, seed=7,
                                   profile="hard")


def with_dataset(cfg, root):
    for key, value in (("eval_input.dataset_root", root),
                       ("eval_input.info_path",
                        f"{root}/kitti_infos_val.pkl"),
                       ("eval_input.num_workers", 2),
                       ("runtime.num_devices", 1)):
        cfg = cfg.override(key, value)
    return cfg


def run_jax(root, scenes, config, weights, sets, excess_precision):
    import os

    if not excess_precision:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pillars_tpu.config import Config
    from pillars_tpu.data import synthetic
    from pillars_tpu.models.detector import PillarsDetector
    from pillars_tpu.train import checkpoint as ckpt
    from pillars_tpu.train.trainer import Evaluator

    ensure_split(synthetic, root)
    cfg = with_dataset(load_config(Config, config, sets), root)
    det = PillarsDetector(cfg)
    params, stats = ckpt.load_params(weights)
    variables = {"params": params, "batch_stats": stats or {}}
    return Evaluator(cfg, det).evaluate(variables, max_samples=scenes)


def run_torch(root, scenes, config, weights, sets, excess_precision):
    from pillars_torch.config import Config
    from pillars_torch.data import synthetic
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.weights import from_jax_variables, load_params

    ensure_split(synthetic, root)
    cfg = with_dataset(load_config(Config, config, sets), root)
    det = PillarsDetector(cfg, device="cpu")
    state = from_jax_variables(*load_params(weights), cfg)
    return Evaluator(cfg, det).evaluate(state, max_samples=scenes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--root", required=True, help="where the dataset goes")
    ap.add_argument("--scenes", type=int, default=None,
                    help="evaluate the first N val scenes only")
    ap.add_argument("--config", default=None,
                    help="model config (default: Config.default())")
    ap.add_argument("--weights", default=str(WEIGHTS),
                    help="checkpoint (default: benchmarks/hard_synth/"
                         "weights_59.pkl)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config overrides, e.g. runtime.compute_dtype="
                         "bfloat16")
    ap.add_argument("--xla-excess-precision", action="store_true",
                    help="JAX: keep XLA's default excess precision")
    ap.add_argument("--write", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()

    from pillars_torch.data.synthetic import split_checksum

    t0 = time.perf_counter()
    run = run_jax if args.package == "jax" else run_torch
    text, bev, d3, aos, score = run(args.root, args.scenes, args.config,
                                    args.weights, args.set,
                                    args.xla_excess_precision)
    weights = pathlib.Path(args.weights).resolve()
    if weights.is_relative_to(ROOT):
        weights = weights.relative_to(ROOT)
    out = {
        "what": f"KITTI AP of {weights} on the hard val split (synth-data "
                f"--profile hard --num-train 600 --num-test 150 --seed 7), "
                f"{args.config or 'Config.default()'}"
                f"{''.join(' ' + s for s in args.set)}, CPU"
                f"{', XLA excess precision on' if args.xla_excess_precision and args.package == 'jax' else ''}",
        "package": args.package,
        "scenes": args.scenes or 150,
        "val_checksum": split_checksum(args.root),
        "aggregate": float(score),
        "mAP_bev": np.asarray(bev).tolist(),
        "mAP_3d": np.asarray(d3).tolist(),
        "mAP_aos": np.asarray(aos).tolist(),
        "ap_text": text,
        "seconds": round(time.perf_counter() - t0, 1),
    }
    if args.against:
        gold = json.loads(pathlib.Path(args.against).read_text())
        out["golden_aggregate"] = gold["aggregate"]
        out["aggregate_minus_golden"] = out["aggregate"] - gold["aggregate"]
        out["same_val_split"] = out["val_checksum"] == gold["val_checksum"]
        out["max_abs_mAP_diff"] = float(max(
            np.abs(np.asarray(out[k]) - np.asarray(gold[k])).max()
            for k in ("mAP_bev", "mAP_3d", "mAP_aos")))
    print(json.dumps(out))
    if args.write:
        pathlib.Path(args.write).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
