"""The rank side of the port's multi-process CPU tests
(tests/test_torch_parallel*.py): functions that
``pillars_torch.parallel.launch.spawn`` runs in each rank. A spawned child
imports this module by name, so it imports the port and nothing of JAX.

A case is a dict: ``overrides`` of ``Config.default()``, the ``mesh`` as
((axis, size), ...), the network ``state`` as arrays, a global ``batch`` of
arrays, the ``ops`` to run ("forward", "postprocess", "grads", "steps",
"metrics", "flat_reduce", "capture")
and ``n_steps``. Each rank writes what it computed to ``rank<r>.pt``
beside the pickled cases.
"""

import os
import pickle

import numpy as np
import torch


def _config(overrides):
    from pillars_torch.config import Config

    cfg = Config.default()
    for key, value in overrides:
        cfg = cfg.override(key, value)
    return cfg


def _detach(tree, clone=False):
    """Every tensor of ``tree`` detached on the CPU (``clone``: copied, a
    snapshot of tensors that a later step writes in place)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.clone() if clone else t
    if isinstance(tree, dict):
        return {k: _detach(v, clone) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = (_detach(v, clone) for v in tree)
        return (type(tree)(*parts) if hasattr(tree, "_fields")
                else type(tree)(parts))
    return tree


def _bn_group_sizes(network):
    """The ranks each BatchNorm reduces its train-mode statistics over."""
    import torch.distributed as dist

    from pillars_torch.models.layers import BatchNorm

    return {name: dist.get_world_size(m.group) if m.group is not None else 1
            for name, m in network.named_modules()
            if isinstance(m, BatchNorm)}


def _bands(det, mesh, heads):
    """This rank's band of the class head (``shard_canvas``) and of the
    flat anchor ids (``shard_anchors_flat``), for the spatial axis."""
    from pillars_torch.parallel.spatial import (shard_anchors_flat,
                                                shard_canvas)

    axis = det.config.runtime.spatial_axis
    if not axis or mesh.group(axis) is None:
        return None
    cls = heads["cls_preds"]
    ids = torch.arange(cls.shape[1] * cls.shape[2]
                       * det.mcfg.num_anchors_per_loc)[None]
    return {"cls": shard_canvas(cls, axis, mesh, 4),
            "anchor_ids": shard_anchors_flat(ids, axis, mesh, cls.shape[1],
                                             4)}


def run_cases(rank, device, cases_file):
    """Each case of the file in turn; writes [each case's outputs]."""
    with open(cases_file, "rb") as f:
        cases = pickle.load(f)
    out = [run_case(rank, device, case) for case in cases]
    # clones: a captured call's outputs are views of one packed buffer
    torch.save(_detach(out, clone=True),
               os.path.join(os.path.dirname(cases_file), f"rank{rank}.pt"))


def run_case(rank, device, case):
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.parallel.mesh import Mesh, shard_batch
    from pillars_torch.train.loop import (TrainState, forward_backward,
                                          make_train_step, split_state)
    from pillars_torch.train.optim import AdamW

    cfg = _config(case["overrides"])
    mesh = Mesh(case["mesh"])
    det = PillarsDetector(cfg, device=device, mesh=mesh)
    state = {k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in case["state"].items()}
    batch = case["batch"]
    data_axis = cfg.runtime.data_axis
    if mesh.group(data_axis) is not None:
        batch = shard_batch(batch, mesh, data_axis)
    out = {"bn_group_sizes": _bn_group_sizes(det.network)}
    for op in case["ops"]:
        if op in ("forward", "postprocess"):
            with torch.inference_mode():
                pts = torch.as_tensor(batch["points"], device=device)
                num = torch.as_tensor(batch["num_points"], device=device)
                vox = det.voxelize_batch(pts, num)
                heads = det.apply(state, vox)
                out["heads"] = heads
                out["bands"] = _bands(det, mesh, heads)
                if op == "postprocess":
                    thr = cfg.eval_input.anchor_area_threshold
                    amask = det.anchors_mask_batch(vox.coords,
                                                   vox.pillar_mask, thr)
                    eye = torch.eye(4, device=device).expand(
                        pts.shape[0], 4, 4)
                    out["preds"] = det.postprocess(heads, amask, eye, eye)
        elif op == "grads":
            params, stats = split_state(state)
            opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
            ts = TrainState(0, params, stats, opt.init(params))
            fb = forward_backward(det, ts, batch,
                                  cfg.train_input.anchor_area_threshold)
            out.update(loss=fb.loss, grads=fb.grads,
                       batch_stats=fb.batch_stats,
                       num_positives=fb.num_positives)
        elif op == "steps":
            params, stats = split_state(state)
            opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
            ts = TrainState(0, params, stats, opt.init(params))
            step = make_train_step(det, opt)
            runs = []
            for _ in range(case.get("n_steps", 2)):
                ts, metrics = step(ts, batch)
                runs.append({"metrics": metrics, "params": ts.params,
                             "batch_stats": ts.batch_stats})
            out["steps"] = runs
        elif op == "metrics":  # a step with the streaming train metrics
            from pillars_torch.train.metrics import TrainMetricsState

            params, stats = split_state(state)
            opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
            ts = TrainState(0, params, stats, opt.init(params))
            step = make_train_step(det, opt, with_metrics=True)
            _, _, _, out["metric_values"] = step(
                ts, TrainMetricsState.init(device), batch)
        elif op == "flat_reduce":  # one step, its flat all-reduces seen
            out["flat_reduce"] = _step_with_flat_reduces(det, cfg, state,
                                                         batch)
        elif op == "capture":
            out["capture"] = _captured_against_eager(det, cfg, state, batch)
        else:
            raise ValueError(op)
    return out


def _step_with_flat_reduces(det, cfg, state, batch):
    """One train step with ``all_reduce_flat`` of the train loop watched:
    for each call the tensors it summed (their count and what it returned),
    and the parameters after the step."""
    from pillars_torch.train import loop
    from pillars_torch.train.optim import AdamW

    calls, inner = [], loop.all_reduce_flat

    def watched(tensors, *args, **kwargs):
        summed = inner(list(tensors), *args, **kwargs)
        calls.append([t.clone() for t in summed])
        return summed

    params, stats = loop.split_state(state)
    opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
    ts = loop.TrainState(0, params, stats, opt.init(params))
    loop.all_reduce_flat = watched
    try:
        ts, metrics = loop.make_train_step(det, opt)(ts, batch)
    finally:
        loop.all_reduce_flat = inner
    return {"calls": calls, "trainable": list(ts.opt_state.mu),
            "params": ts.params, "metrics": metrics}


def _captured_against_eager(det, cfg, state, batch):
    """The captured paths over this rank's mesh, with the stand-in graph of
    tests/test_torch_train_capture.py (the capture runs the body and
    restores the state it wrote; a replay reruns the body, collectives and
    all): two steps of a ``CapturedTrainStep`` against two eager steps from
    the same state, its donation, and its body replayed under the sync
    check of tests/test_torch_capture.py; on a spatial band the inference
    body too, under the check and through a ``CapturedInference`` against
    the eager function."""
    import functools

    from pillars_torch import cuda_graph
    from pillars_torch.models.detector import Predictions
    from pillars_torch.train.loop import (CapturedTrainStep, TrainState,
                                          make_train_step, split_state)
    from pillars_torch.train.optim import AdamW

    threads = torch.get_num_threads()
    from test_torch_capture import _SyncCheck
    from test_torch_train_capture import _Capture
    torch.set_num_threads(threads)  # those modules set their own

    saved = cuda_graph._capture_graph, cuda_graph._run_on_side_stream
    capture = _Capture()
    cuda_graph._capture_graph = capture
    cuda_graph._run_on_side_stream = lambda run, device: run()
    try:
        params, stats = split_state(state)
        opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
        ts = TrainState(0, params, stats, opt.init(params))
        before = _detach(params, clone=True)
        eager = make_train_step(det, opt)
        step = CapturedTrainStep(det, opt,
                                 cfg.train_input.anchor_area_threshold,
                                 False, True, eager)
        capture.states.append(step.static)
        out = {"eager_is_eager": eager.eager is eager, "eager": [],
               "captured": [], "copies": []}
        want, got = ts, ts
        for _ in range(2):
            want, m_want = eager(want, batch)
            got, m_got = step(got, batch)
            out["eager"].append(m_want)
            out["captured"].append(m_got)
            out["copies"].append(step.static.copies)
        # the state returned holds the static tensors, which the replay
        # under the check below writes again
        out["eager_state"] = want
        out["captured_state"] = _detach(got, clone=True)
        out["donated"] = all(got.params[k] is
                             step.static.tensors[f"params/{k}"]
                             for k in got.params)
        out["untouched"] = all(torch.equal(params[k], v)
                               for k, v in before.items())
        (graph,) = step.graphs.values()
        out["replays"] = graph.graph.replays
        check = _SyncCheck()
        with check:
            graph.graph.replay()
        out["train_sync"] = check.found
        if det.network.spatial is not None:  # a band: its inference
            thr = cfg.eval_input.anchor_area_threshold
            pts = torch.as_tensor(batch["points"])
            num = torch.as_tensor(batch["num_points"])
            eye = torch.eye(4).expand(pts.shape[0], 4, 4)
            fn = det.make_inference_fn(thr)
            static = cuda_graph.StaticState()
            captured = cuda_graph.CapturedInference(
                functools.partial(det._infer, thr=thr, folded=static),
                fn.eager, static, "cpu", Predictions)
            out["infer"] = [captured(state, pts, num, eye, eye),
                            captured(state, pts, num, eye, eye),
                            fn.eager(state, pts, num, eye, eye)]
            check = _SyncCheck()
            with torch.inference_mode(), check:
                det._infer(state, pts, num, eye, eye, thr)
            out["infer_sync"] = check.found
    finally:
        cuda_graph._capture_graph, cuda_graph._run_on_side_stream = saved
    return out


def spawn_cases(out_dir, world_size, cases):
    """Run ``cases`` (dicts as the module docstring says) one after the
    other in ``world_size`` gloo CPU ranks of one spawn; returns
    outputs[case][rank]."""
    from pillars_torch.parallel.launch import spawn

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(list(cases), f)
    spawn(run_cases, world_size, args=(path,), threads=1)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(world_size)]
    return [[r[i] for r in ranks] for i in range(len(cases))]


def run_trainer(rank, device, spec_file):
    """A data-parallel ``Trainer`` epoch with its eval, the overfit and
    replay fixtures, and a data-parallel ``Evaluator`` run, as the spec
    file says; writes each rank's results to ``rank<r>.pt``."""
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator, Trainer

    with open(spec_file, "rb") as f:
        spec = pickle.load(f)
    cfg = _config(spec["overrides"])
    out = {}
    t = Trainer(cfg.override("out_dir", spec["out"] + "/epoch"),
                device=device)
    out["best"] = t.train(epochs=1)
    out["epoch_params"] = t.state.params
    out["steps"] = t.state.step

    cfg_fx = cfg.override("train.do_evaluate", False)
    t = Trainer(cfg_fx.override("out_dir", spec["out"] + "/fixture"),
                device=device)
    t.train(epochs=1, overfit_first_batch=True,
            save_batch_file=spec["out"] + "/batch.pkl", fixture_repeats=3)
    out["overfit_steps"] = t.state.step
    t2 = Trainer(cfg_fx.override("out_dir", spec["out"] + "/replay"),
                 device=device)
    t2.train(epochs=1, replay_batch_file=spec["out"] + "/batch.pkl",
             fixture_repeats=2)
    out["replay_steps"] = t2.state.step
    out["replay_params"] = t2.state.params

    det = PillarsDetector(cfg, device=device)
    state = {k: torch.as_tensor(np.asarray(v)) for k, v in
             spec["eval_state"].items()}
    ev = Evaluator(cfg, det)
    out["eval_split"] = ev.mesh is not None
    out["annos"], _ = ev.run(state, progress=False)
    torch.save(_detach(out), os.path.join(os.path.dirname(spec_file),
                                          f"rank{rank}.pt"))
