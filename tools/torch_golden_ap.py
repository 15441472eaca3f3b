"""The accuracy anchor of the PyTorch port: KITTI AP of the trained d435i
checkpoint on the regenerated hard validation split, through either package
on the CPU.

    python tools/torch_golden_ap.py --package jax   --root DIR [--scenes N]
                                    [--write tests/golden/torch_hard_val_ap.json]
    python tools/torch_golden_ap.py --package torch --root DIR [--scenes N]
                                    [--against tests/golden/torch_hard_val_ap.json]

Regenerates the dataset of benchmarks/hard_synth/README.md (600 train / 150
val hard-profile scenes, seed 7) under ``--root`` with the chosen package's
own generator, runs that package's ``Evaluator`` with
benchmarks/hard_synth/weights_59.pkl, and prints one JSON object: the val
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


def with_dataset(cfg, root):
    for key, value in (("eval_input.dataset_root", root),
                       ("eval_input.info_path",
                        f"{root}/kitti_infos_val.pkl"),
                       ("eval_input.num_workers", 2),
                       ("runtime.num_devices", 1)):
        cfg = cfg.override(key, value)
    return cfg


def run_jax(root, scenes):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pillars_tpu.config import Config
    from pillars_tpu.data import synthetic
    from pillars_tpu.models.detector import PillarsDetector
    from pillars_tpu.train import checkpoint as ckpt
    from pillars_tpu.train.trainer import Evaluator

    synthetic.generate_dataset(root, num_train=600, num_test=150, seed=7,
                               profile="hard")
    cfg = with_dataset(Config.default(), root)
    det = PillarsDetector(cfg)
    params, stats = ckpt.load_params(str(WEIGHTS))
    variables = {"params": params, "batch_stats": stats or {}}
    return Evaluator(cfg, det).evaluate(variables, max_samples=scenes)


def run_torch(root, scenes):
    from pillars_torch.config import Config
    from pillars_torch.data import synthetic
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.weights import from_jax_variables, load_params

    synthetic.generate_dataset(root, num_train=600, num_test=150, seed=7,
                               profile="hard")
    cfg = with_dataset(Config.default(), root)
    det = PillarsDetector(cfg, device="cpu")
    state = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
    return Evaluator(cfg, det).evaluate(state, max_samples=scenes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--root", required=True, help="where the dataset goes")
    ap.add_argument("--scenes", type=int, default=None,
                    help="evaluate the first N val scenes only")
    ap.add_argument("--write", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()

    from pillars_torch.data.synthetic import split_checksum

    t0 = time.perf_counter()
    run = run_jax if args.package == "jax" else run_torch
    text, bev, d3, aos, score = run(args.root, args.scenes)
    out = {
        "what": "KITTI AP of benchmarks/hard_synth/weights_59.pkl on the "
                "hard val split (synth-data --profile hard --num-train 600 "
                "--num-test 150 --seed 7), Config.default(), CPU, f32",
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
