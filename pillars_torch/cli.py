"""Command-line interface of the port (pillars_tpu/cli.py).

    pillars-torch evaluate --config cfg.yaml --checkpoint weights.pkl
    pillars-torch stream --config cfg.yaml --checkpoint weights.pkl --hz 120
    pillars-torch create-data --root DATASET --num-train N [--num-test M]
    pillars-torch synth-data --root DIR ...

Every command that runs the detector runs it on the card; ``--device cpu``
asks for the CPU. ``train``, ``capture``, ``sample-val-data``, ``visualize``
and ``bench`` are not ported yet and say so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

# subcommands of the JAX package's CLI that a later slice of the port brings
_NOT_PORTED = {
    "train": "the training slice (Trainer, losses, optimizer)",
    "capture": "the capture slice (data/capture.py)",
    "sample-val-data": "the training slice (data/val_sampling.py)",
    "visualize": "the visualization slice (viz/plot.py)",
    "bench": "the benchmark slice (bench_torch.py)",
}


def _load_config(args):
    from pillars_torch.config import Config

    cfg = Config.from_yaml(args.config) if args.config else Config.default()
    if getattr(args, "set", None):
        cfg = cfg.overrides(args.set)
    if cfg.runtime.xla_flags:
        print("[config] runtime.xla_flags has no meaning for the PyTorch "
              "port; ignored", file=sys.stderr)
    return cfg


def _detector_and_state(args, cfg, who):
    """The detector on ``--device`` and its state: the checkpoint's, or a
    seeded random one."""
    import torch

    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.weights import from_jax_variables, load_params

    det = PillarsDetector(cfg, device=args.device)
    if args.checkpoint:
        state = det.state_to_device(
            from_jax_variables(*load_params(args.checkpoint), cfg))
    else:
        print(f"[{who}] no checkpoint given - random init", file=sys.stderr)
        state = det.init(torch.Generator().manual_seed(0), batch_size=1)
    return det, state


def cmd_evaluate(args):
    from pillars_torch.infer import parse_bucket_arg
    from pillars_torch.train.trainer import Evaluator

    cfg = _load_config(args)
    det, state = _detector_and_state(args, cfg, "evaluate")
    buckets = parse_bucket_arg(
        getattr(args, "buckets", None) or cfg.eval_input.buckets,
        cfg.model.voxel.max_points)
    ev = Evaluator(cfg, det, measure_time=cfg.runtime.measure_time,
                   buckets=buckets)
    if args.save_predictions:
        # fail on an unwritable destination BEFORE the eval loop runs,
        # not after minutes of inference
        os.makedirs(os.path.dirname(os.path.abspath(args.save_predictions)),
                    exist_ok=True)
    if cfg.eval_input.no_annos_mode:
        # predictions only: no labels to score against (reference
        # README.md:247-260, train.py:876-880): pickle the dt annos for
        # the visualizer and skip the official eval
        save = args.save_predictions or os.path.join(
            cfg.out_dir or ".", "result.pkl")
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        dt_annos, _ = ev.run(state, max_samples=args.max_samples,
                             save_path=save)
        print(f"[evaluate] no_annos_mode: {len(dt_annos)} prediction annos "
              f"saved to {save}; no AP (no labels)")
        return
    if args.coco:
        # COCO-style AP over an IoU range (reference train.py:918, kept
        # commented out there; eval.py:920-997)
        from pillars_torch.eval import kitti_ap

        dt_annos, gt_annos = ev.run(state, max_samples=args.max_samples,
                                    save_path=args.save_predictions)
        result, _, _, _, _ = kitti_ap.get_coco_eval_result(
            gt_annos, dt_annos, ev.class_names, compute_bbox=False)
        print(result)
        return
    result, bev, d3, aos, score = ev.evaluate(
        state, max_samples=args.max_samples,
        save_path=args.save_predictions)
    print(result)
    print(f"aggregate score: {score:.2f}")


def cmd_create_data(args):
    from pillars_torch.data import kitti_infos as ki

    ids = list(range(args.num_train))
    info_path = ki.create_info_file(args.root, ids, training=True)
    print(f"info file: {info_path}")
    db = ki.create_groundtruth_database(
        args.root, used_classes=args.classes or ["Pedestrian"])
    print(f"gt database: {db}")
    if args.num_test:
        import pickle

        infos = ki.get_image_infos(args.root, list(range(args.num_test)),
                                   training=False)
        ki.calculate_num_points_in_gt(args.root, infos)
        out = f"{args.root}/kitti_infos_val.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f, 2)
        print(f"val info file: {out}")


def cmd_synth_data(args):
    from pillars_torch.data import synthetic

    root = synthetic.generate_dataset(
        args.root, num_train=args.num_train, num_test=args.num_test,
        seed=args.seed, profile=args.profile)
    print(f"synthetic dataset at {root} (profile={args.profile})")


def cmd_stream(args):
    from pillars_torch.data.stream import run_stream
    from pillars_torch.infer import parse_bucket_arg

    cfg = _load_config(args)
    buckets = parse_bucket_arg(args.buckets, cfg.model.voxel.max_points)
    if args.num_streams > 1:
        # multi-stream serving is synthetic-source, fixed-shape only:
        # refuse the combinations we would otherwise silently ignore
        if buckets is not None:
            raise SystemExit(
                "--num-streams > 1 does not support --buckets (the batch "
                "is one padded width)")
        if args.source != "synthetic":
            raise SystemExit(
                "--num-streams > 1 supports only --source synthetic")
    det, state = _detector_and_state(args, cfg, "stream")
    if args.num_streams > 1:
        from pillars_torch.data.stream import run_multi_stream
        stats = run_multi_stream(cfg, det, state,
                                 num_streams=args.num_streams, hz=args.hz,
                                 duration_s=args.duration,
                                 window=args.window)
        print(json.dumps(stats))
        return
    publisher = None
    if args.viz_dir:
        from pillars_torch.viz.publisher import make_publisher

        publisher = make_publisher("offline", out_dir=args.viz_dir)
    stats = run_stream(cfg, det, state, hz=args.hz,
                       duration_s=args.duration,
                       source=args.source, window=args.window,
                       buckets=buckets, publisher=publisher)
    print(json.dumps(stats))


def cmd_not_ported(args):
    raise SystemExit(
        f"pillars-torch {args.cmd}: not ported yet; it comes with "
        f"{_NOT_PORTED[args.cmd]}. The JAX package has it: "
        f"pillars-tpu {args.cmd}")


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(prog="pillars-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default=None,
                        help="YAML config (native or reference train.yaml)")
        sp.add_argument("--set", nargs="*", default=[],
                        help="dotted-path overrides key=value")
        sp.add_argument("--device", default=None,
                        help="torch device; default the card (cuda), which "
                             "must be there. 'cpu' must be asked for")

    sp = sub.add_parser("evaluate", help="offline KITTI AP evaluation")
    common(sp)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--max-samples", type=int, default=None)
    sp.add_argument("--coco", action="store_true",
                    help="COCO-style AP over an IoU range instead of the "
                         "6-threshold official eval")
    sp.add_argument("--save-predictions", default=None,
                    help="pickle the dt annos here (default in "
                         "no_annos_mode: <out_dir>/result.pkl)")
    sp.add_argument("--buckets", default=None,
                    help="point-count bucket ladder (a,b,c | auto) for "
                         "bucketed dispatch during eval")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("create-data",
                        help="build info files + gt database from a dataset")
    sp.add_argument("--root", required=True)
    sp.add_argument("--num-train", type=int, required=True)
    sp.add_argument("--num-test", type=int, default=0)
    sp.add_argument("--classes", nargs="*", default=None)
    sp.set_defaults(fn=cmd_create_data)

    sp = sub.add_parser("synth-data", help="generate a synthetic dataset")
    sp.add_argument("--root", required=True)
    sp.add_argument("--num-train", type=int, default=32)
    sp.add_argument("--num-test", type=int, default=8)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--profile", default="easy",
                    choices=["easy", "hard", "kitti3"],
                    help="hard = stratified occlusion/sparsity benchmark; "
                         "kitti3 = full-LiDAR-scale 3-class scenes for "
                         "configs/kitti_3class.yaml")
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("stream", help="streaming inference (replay/live)")
    common(sp)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--hz", type=float, default=120.0)
    sp.add_argument("--duration", type=float, default=5.0)
    sp.add_argument("--source", default="synthetic",
                    help="synthetic | replay:<dataset_root>")
    sp.add_argument("--window", type=int, default=8,
                    help="bounded in-flight depth (overlapped readbacks)")
    sp.add_argument("--buckets", default=None,
                    help="comma-separated point-count bucket ladder "
                         "(e.g. 9984,19968) for bucketed dispatch; 'auto' "
                         "derives a halving ladder from "
                         "model.voxel.max_points")
    sp.add_argument("--num-streams", type=int, default=1,
                    help=">1 serves N independent synthetic sensor streams "
                         "through ONE batched call (multi-sensor serving; "
                         "per-stream drop-oldest mailboxes)")
    sp.add_argument("--viz-dir", default=None,
                    help="record the reference RVIZ topic stream "
                         "(debug_points + bb_pred_guess_1) per frame to "
                         "this directory via the OfflinePublisher")
    sp.set_defaults(fn=cmd_stream)

    for name, slice_ in _NOT_PORTED.items():
        sp = sub.add_parser(name, help=f"not ported yet ({slice_})")
        sp.set_defaults(fn=cmd_not_ported)

    args, rest = p.parse_known_args(argv)
    if rest and args.cmd not in _NOT_PORTED:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
