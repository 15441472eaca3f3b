"""Command-line interface of the port (pillars_tpu/cli.py).

    pillars-torch train --config cfg.yaml [--set key=value ...] [--resume ck]
    pillars-torch evaluate --config cfg.yaml --checkpoint weights.pkl
    pillars-torch stream --config cfg.yaml --checkpoint weights.pkl --hz 120
                         [--trace FILE]
    pillars-torch create-data --root DATASET --num-train N [--num-test M]
    pillars-torch synth-data --root DIR ...
    pillars-torch sample-val-data --val-info INFOS.pkl ...
    pillars-torch capture --root DIR [--mode predefined|unannotated|annotate]
    pillars-torch visualize --root DATASET [--result result_<epoch>.pkl]
    pillars-torch bench [--path dense|fast] [--dtype float32|bfloat16] ...

Every command that runs the detector runs it on the card; ``--device cpu``
asks for the CPU. ``bench`` is the port's headline benchmark
(pillars_torch/bench.py): the captured batch-1 inference rate, one JSON line.

``train`` and ``evaluate`` with ``--set runtime.num_devices=N`` (N > 1)
start N ranks (pillars_torch/parallel/launch.py): N NCCL ranks on N cards
(fewer cards raise), or with ``--device cpu`` N gloo ranks on the CPU. Rank
0 prints and writes; the others print nothing. On the cards the train step
replays a captured CUDA graph with its NCCL collectives inside, and the
evaluation's per-rank inference its own graph; on the CPU both run eagerly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

def _load_config(args):
    from pillars_torch.config import Config

    cfg = Config.from_yaml(args.config) if args.config else Config.default()
    if getattr(args, "set", None):
        cfg = cfg.overrides(args.set)
    if cfg.runtime.xla_flags:
        print("[config] runtime.xla_flags has no meaning for the PyTorch "
              "port; ignored", file=sys.stderr)
    return cfg


def _in_ranks(args, cfg, cmd) -> bool:
    """Start ``runtime.num_devices`` ranks that each run ``cmd(args)`` on
    their device and wait for them; False (nothing started) for one device
    or inside a rank."""
    import torch.distributed as dist

    from pillars_torch import resolve_device
    from pillars_torch.parallel import launch

    if dist.is_initialized():
        return False
    n = (cfg.runtime.num_devices
         or launch.visible_devices(resolve_device(args.device)))
    if n <= 1:
        return False
    launch.spawn(_rank_main, n, args=(cmd.__name__, args),
                 device=args.device or "cuda")
    return True


def _rank_main(rank, device, cmd_name, args):
    if rank:
        sys.stdout = open(os.devnull, "w")
    globals()[cmd_name](argparse.Namespace(**dict(vars(args),
                                                  device=str(device))))


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


def cmd_train(args):
    from pillars_torch.train.trainer import Trainer

    cfg = _load_config(args)
    if _in_ranks(args, cfg, cmd_train):
        return
    trainer = Trainer(cfg, use_wandb=args.wandb, device=args.device)
    if args.resume:
        step = trainer.resume(args.resume)
        print(f"resumed from {args.resume} at step {step}")
    best = trainer.train(epochs=args.epochs,
                         eval_max_samples=args.eval_max_samples,
                         overfit_first_batch=args.overfit_first_batch,
                         replay_batch_file=args.replay_batch_file)
    print(f"best eval score: {best:.2f}")


def cmd_capture(args):
    """Dataset capture (reference scripts/realsense_make_dataset.py CLI:
    ``live_mode_off DATASETPATH ROTATION START_IDX END_IDX train`` is
    ``capture --mode predefined --rotation R --start S --end E``;
    ``live_mode_on`` is ``--mode unannotated``). Headless sources:
    synthetic | replay:<dataset_root>; ``ros`` subscribes the live
    RealSense topic where rospy exists."""
    import itertools

    import numpy as np

    from pillars_torch.data import capture as cap

    if args.mode == "annotate":
        # interactive keyboard annotation over already-captured clouds
        # (reference realsense_make_dataset.py:622-801: enter save, m save
        # empty, h skip, z back, x quit; wasd/qe/rf edit the box live)
        from pillars_torch.viz.publisher import make_publisher

        pub = make_publisher(args.publisher, out_dir=args.viz_dir)
        stats = cap.annotate_dataset(
            args.root, cap.stdin_key_source(), split=args.split,
            publisher=pub, start_idx=args.start, verbose=True)
        print(f"[capture] annotate done: {stats['annotated']} annotated, "
              f"{stats['empty']} empty, {stats['skipped']} skipped "
              f"(stopped at frame {stats['last_index']})")
        return

    def frame_iter():
        if args.source == "synthetic":
            from pillars_torch.data.synthetic import make_scene

            rng = np.random.RandomState(args.seed)
            while True:
                points, _ = make_scene(rng)
                yield points  # already lidar coords
        elif args.source.startswith("replay:"):
            import pickle

            root = args.source.split(":", 1)[1]
            sub = "training/velodyne"
            d = os.path.join(root, sub)
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), "rb") as f:
                    yield np.asarray(pickle.load(f), dtype=np.float32)
        elif args.source == "ros":
            from pillars_torch.data.stream import (LatestFrameMailbox,
                                                   ros_source)

            mailbox = LatestFrameMailbox()
            ros_source(mailbox)
            while True:
                frame, _skipped = mailbox.take(timeout=5.0)
                if frame is None:
                    return
                yield frame
        else:
            raise SystemExit(f"unknown capture source {args.source!r}")

    # every source yields lidar-frame clouds: replay/synthetic natively,
    # and ros_source applies d435i_to_lidar (+1::4 subsample) in its
    # subscriber callback (data/stream.py) — transforming again here
    # would double-rotate and double-subsample
    already_lidar = True
    frames = itertools.islice(frame_iter(), args.start, args.end)
    if args.mode == "predefined":
        rotations = ([args.rotation] if args.rotation is not None
                     else cap.PREDEFINED_ROTATIONS)
        n = cap.capture_predefined(frames, args.root,
                                   every_nth=args.every_nth,
                                   rotations=rotations,
                                   already_lidar=already_lidar,
                                   max_frames=args.max_frames)
    else:
        n = cap.capture_unannotated(frames, args.root,
                                    already_lidar=already_lidar,
                                    max_frames=args.max_frames)
    if args.mode == "predefined":
        print(f"[capture] saved {n} predefined clouds to "
              f"{args.root}/training (next: pillars-torch create-data "
              f"--root {args.root} --num-train {n})")
    else:
        print(f"[capture] saved {n} unannotated clouds to "
              f"{args.root}/testing (next: pillars-torch create-data "
              f"--root {args.root} --num-train 0 --num-test {n})")


def cmd_sample_val_data(args):
    from pillars_torch.data.val_sampling import create_sampled_val_dataset

    cfg = _load_config(args)
    out = create_sampled_val_dataset(cfg, args.val_info, seed=args.seed)
    print(f"sampled val info file: {out}")


def cmd_evaluate(args):
    from pillars_torch.infer import parse_bucket_arg
    from pillars_torch.train.trainer import Evaluator

    cfg = _load_config(args)
    if _in_ranks(args, cfg, cmd_evaluate):
        return
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
    from pillars_torch.utils import tracing

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
    if args.trace:
        # before the detector: the builds, the capture and its device marks
        tracing.enable()
    det, state = _detector_and_state(args, cfg, "stream")
    if args.num_streams > 1:
        from pillars_torch.data.stream import run_multi_stream
        stats = run_multi_stream(cfg, det, state,
                                 num_streams=args.num_streams, hz=args.hz,
                                 duration_s=args.duration,
                                 window=args.window)
    else:
        publisher = None
        if args.viz_dir:
            from pillars_torch.viz.publisher import make_publisher

            publisher = make_publisher("offline", out_dir=args.viz_dir)
        stats = run_stream(cfg, det, state, hz=args.hz,
                           duration_s=args.duration,
                           source=args.source, window=args.window,
                           buckets=buckets, publisher=publisher)
    if args.trace:
        stats["spans"] = {k: {"count": v["count"], "total_ms": v["ns"] / 1e6,
                              "max_ms": v["max_ns"] / 1e6}
                          for k, v in sorted(tracing.snapshot().items())}
        stats["counters"] = tracing.counters()
        tracing.dump(args.trace)
    print(json.dumps(stats))


def cmd_visualize(args):
    """Render dataset frames + optional predictions to BEV PNGs — the
    headless analogue of the reference's rviz_show_predictions.py."""
    import pickle

    import numpy as np

    from pillars_torch.viz import plot

    cfg = _load_config(args)
    with open(f"{args.root}/{args.info}", "rb") as f:
        infos = pickle.load(f)
    dt_annos = None
    if args.result:
        with open(args.result, "rb") as f:
            dt_annos = pickle.load(f)
    from pillars_torch.geometry import np_boxes as nb

    os.makedirs(args.out, exist_ok=True)
    count = 0
    for i, info in enumerate(infos[: args.max_frames]):
        path = f"{args.root}/{info['velodyne_path']}"
        with open(path[:-3] + "pkl", "rb") as f:
            points = pickle.load(f, encoding="latin1")
        annos = info["annos"]
        gt_cam = np.concatenate(
            [annos["location"], annos["dimensions"],
             annos["rotation_y"][..., None]], axis=1)
        gt = nb.box_camera_to_lidar(gt_cam, info["calib/R0_rect"],
                                    info["calib/Tr_velo_to_cam"])
        pred, scores = None, None
        if dt_annos is not None and i < len(dt_annos):
            da = dt_annos[i]
            if len(da["name"]):
                cam = np.concatenate(
                    [da["location"], da["dimensions"],
                     da["rotation_y"][..., None]], axis=1)
                pred = nb.box_camera_to_lidar(
                    cam, info["calib/R0_rect"], info["calib/Tr_velo_to_cam"])
                scores = da["score"]
                keep = scores >= args.min_score
                pred, scores = pred[keep], scores[keep]
        plot.plot_bev(points=points, gt_boxes=gt, pred_boxes=pred,
                      scores=scores,
                      point_cloud_range=cfg.model.voxel.point_cloud_range,
                      save_path=f"{args.out}/{i:06d}.png")
        count += 1
    print(f"rendered {count} frames to {args.out}")


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

    sp = sub.add_parser("train", help="train the detector")
    common(sp)
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--eval-max-samples", type=int, default=None)
    sp.add_argument("--wandb", action="store_true")
    sp.add_argument("--resume", default=None,
                    help="checkpoint to restore the full train state from "
                         "(the port's or the JAX package's)")
    sp.add_argument("--overfit-first-batch", action="store_true")
    sp.add_argument("--replay-batch-file", default=None)
    sp.set_defaults(fn=cmd_train)

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

    sp = sub.add_parser("sample-val-data",
                        help="build an augmented eval set from the val split "
                             "(the reference's sample_val_dataset_mode)")
    common(sp)
    sp.add_argument("--val-info", required=True)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_sample_val_data)

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
    sp.add_argument("--trace", default=None, metavar="FILE",
                    help="turn tracing on: the stats gain the span totals "
                         "and counters, and FILE the spans as a Chrome "
                         "trace")
    sp.set_defaults(fn=cmd_stream)

    sp = sub.add_parser(
        "capture",
        help="dataset capture + few-annotation trick (the reference's "
             "scripts/realsense_make_dataset.py)")
    sp.add_argument("--root", required=True)
    sp.add_argument("--mode",
                    choices=["predefined", "unannotated", "annotate"],
                    default="predefined",
                    help="predefined = live_mode_off (every Nth cloud gets "
                         "the predefined box); unannotated = live_mode_on; "
                         "annotate = interactive keyboard annotation over "
                         "the saved clouds of --root (reference "
                         "callback_real_annotation_anno)")
    sp.add_argument("--split", default="training",
                    choices=["training", "testing"],
                    help="annotate mode: which split's clouds to annotate")
    sp.add_argument("--publisher", default="auto",
                    choices=["auto", "ros", "offline", "null"],
                    help="annotate mode: where live feedback goes (ros = "
                         "RVIZ topics debug_points/debug_load_data_bb; "
                         "offline records to --viz-dir)")
    sp.add_argument("--viz-dir", default=None,
                    help="annotate mode: out dir for --publisher offline")
    sp.add_argument("--source", default="synthetic",
                    help="synthetic | replay:<dataset_root> | ros")
    sp.add_argument("--rotation", type=float, default=None,
                    help="fixed box rotation for this run (reference "
                         "ROTATION arg); default cycles the 8 predefined")
    sp.add_argument("--start", type=int, default=0)
    sp.add_argument("--end", type=int, default=None)
    sp.add_argument("--every-nth", type=int, default=4)
    sp.add_argument("--max-frames", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_capture)

    sp = sub.add_parser("visualize",
                        help="render frames + predictions to BEV PNGs")
    common(sp)
    sp.add_argument("--root", required=True)
    sp.add_argument("--info", default="kitti_infos_val.pkl")
    sp.add_argument("--result", default=None,
                    help="result_<epoch>.pkl from an eval run")
    sp.add_argument("--out", default="viz_out")
    sp.add_argument("--max-frames", type=int, default=20)
    sp.add_argument("--min-score", type=float, default=0.45)
    sp.set_defaults(fn=cmd_visualize)

    sp = sub.add_parser("bench",
                        help="the headline benchmark: batch-1 inference "
                             "rate on the card, one JSON line")
    from pillars_torch import bench

    bench.add_arguments(sp)
    sp.set_defaults(fn=bench.main)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
