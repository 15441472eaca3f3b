"""How far apart faithful bfloat16 training implementations land, on the
CPU: the yardsticks behind the bf16 training criteria of tests/
torch_parity.py and of chip_smoke.py phase 16.

    python tools/torch_bf16_train_spread.py [--seeds 1 2 3 4]
    python tools/torch_bf16_train_spread.py --full-width --root DIR
    ONEDNN_MAX_CPU_ISA=AVX2 python tools/torch_bf16_train_spread.py \
        --networks
    ONEDNN_MAX_CPU_ISA=AVX512_CORE python tools/torch_bf16_train_spread.py \
        --inference

Default: the reduced ``torch_parity.train_config`` (B=2) with NumPy-seeded
random weights, per seed: the train-mode heads of the port (A), of the port
with oneDNN's bfloat16 convs off (B) and of the JAX package compiled with
XLA's excess precision off (J), each pair's rms distance over the JAX
package's bf16-f32 rms gap; for the first seed also one step's loss parts
(|x - y| over the gap, and relative) and the worst gradient leaf. With
``--full-width``: ``Config.default()`` from benchmarks/hard_synth/
weights_59.pkl on the first B=2 batch of a hard-profile split generated
under ``--root`` (8 train clouds, seed 7), A against B relative to the
port's own bf16-f32 gap (no JAX), and the ATen ops of one f32 and one bf16
train step (a CPU proxy of the card's launches). With ``--networks``: the
train-mode forward of the four networks of tests/test_torch_bf16_train.py
on its inputs (worst head and worst new statistic). With ``--inference``:
the reduced random-init bf16 inference paths of tests/test_torch_bf16.py
on its inputs, A, B and J's heads (share of elements apart) and the
relative box tolerance each pair of predictions needs (the yardstick of
``torch_parity.BF16_BOX_RTOL_RANDOM_INIT``). oneDNN's instruction set
is another faithful variant: run under ``ONEDNN_MAX_CPU_ISA=AVX512_CORE``
or ``AVX2``. Prints one JSON object per measurement.
"""

import argparse
import json
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _ratio(x, y, gap_a, gap_b):
    return _rms(np.asarray(x, np.float64) - np.asarray(y, np.float64)) / _rms(
        np.asarray(gap_a, np.float64) - np.asarray(gap_b, np.float64))


def _np(t):
    return t.detach().float().numpy() if hasattr(t, "detach") else np.asarray(
        t, np.float32)


def networks():
    """The train-mode forward of the four networks of
    tests/test_torch_bf16_train.py on its inputs: the worst head and the
    worst new statistic, A-J and A-B over J's gap."""
    import conftest  # noqa: F401  (JAX on the CPU)
    import test_torch_bf16_train as T
    from pillars_torch.weights import convert_tree

    for name in sorted(T.NETWORKS):
        s = T._setup(name, batch_seed=3 if name.startswith("second") else 1)
        (w, ws), (w32, ws32) = (T._jax_forward(s["jcfg"], s["variables"],
                                               s["jv"], d)
                                for d in ("bfloat16", "float32"))
        a, sa = s["tdet"].apply(s["state"], s["tv"], train=True)
        with torch.backends.mkldnn.flags(enabled=False):
            b, sb = s["tdet"].apply(s["state"], s["tv"], train=True)
        ws, ws32 = (convert_tree({}, t["batch_stats"]) for t in (ws, ws32))
        out = {"what": "train-mode forward, reduced", "network": name}
        for pair, x, y, sx, sy in (("A-J", a, w, sa, ws), ("A-B", a, b, sa,
                                                            sb)):
            out[f"heads {pair}"] = max(_ratio(_np(x[k]), _np(y[k]), w[k],
                                              w32[k]) for k in w)
            out[f"statistics {pair}"] = max(
                _ratio(sx[k].numpy(), _np(sy[k]), ws[k].numpy(),
                       ws32[k].numpy()) for k in ws)
        print(json.dumps(out))


def reduced(seeds):
    import conftest  # noqa: F401  (JAX on the CPU)
    import test_torch_bf16_train as T

    for seed in seeds:
        s = T._setup("point_major", seed=seed, batch_seed=seed)
        want = T._jax_forward(s["jcfg"], s["variables"], s["jv"],
                              "bfloat16")[0]
        want32 = T._jax_forward(s["jcfg"], s["variables"], s["jv"],
                                "float32")[0]
        a = s["tdet"].apply(s["state"], s["tv"], train=True)[0]
        with torch.backends.mkldnn.flags(enabled=False):
            b = s["tdet"].apply(s["state"], s["tv"], train=True)[0]
        print(json.dumps({"what": "train-mode heads, reduced", "seed": seed,
                          **{f"{k} {pair}": round(_ratio(
                              _np(x[k]), _np(y[k]), want[k], want32[k]), 4)
                             for k in sorted(want)
                             for pair, x, y in (("A-J", a, want),
                                                ("B-J", b, want),
                                                ("A-B", a, b))}}))
        if seed != seeds[0]:
            continue
        jl, jg = T._jax_loss_and_grads(s, "bfloat16")
        jl32, jg32 = T._jax_loss_and_grads(s, "float32")
        la, ga = T._port_loss_and_grads(s)
        with torch.backends.mkldnn.flags(enabled=False):
            lb, gb = T._port_loss_and_grads(s)
        ga, gb = dict(T._leaves(ga)), dict(T._leaves(gb))
        for field, x, y, w, w32 in zip(la._fields, la, lb, jl, jl32):
            x, y, w, w32 = float(x), float(y), float(w), float(w32)
            gap = abs(w - w32)
            print(json.dumps({"what": "one-step loss part, reduced",
                              "part": field, "A-J/gap": abs(x - w) / gap,
                              "A-J rel": abs(x - w) / abs(w),
                              "A-B/gap": abs(x - y) / gap,
                              "A-B rel": abs(x - y) / abs(w)}))
        worst = {pair: max((_ratio(x[k], y[k], jg[k], jg32[k]), k)
                           for k in jg)
                 for pair, x, y in (("A-J", ga, jg), ("A-B", ga, gb))}
        print(json.dumps({"what": "one-step gradient leaves, reduced",
                          "worst rms over the gap": worst}))
    # three AdamW steps from one start (the test's), A and B against J
    runs = T.three_step_runs()
    with torch.backends.mkldnn.flags(enabled=False):
        b_state, b_metrics = T.port_steps(runs["start"], runs["batches"])
    a_state, a_metrics = runs["port"]
    j_state, j_metrics = runs["bfloat16"]
    j32_state, j32_metrics = runs["float32"]
    for i, ms in enumerate(zip(a_metrics, b_metrics, j_metrics,
                               j32_metrics)):
        for field in ms[0]._fields[:6]:
            x, y, w, w32 = (float(getattr(m, field)) for m in ms)
            gap = abs(w - w32)
            print(json.dumps({"what": "AdamW step loss part, reduced",
                              "step": i, "part": field,
                              "A-J/gap": abs(x - w) / gap,
                              "A-J rel": abs(x - w) / abs(w),
                              "A-B/gap": abs(x - y) / gap,
                              "A-B rel": abs(x - y) / abs(w)}))
    from pillars_torch.weights import params_to_jax_tree

    pa, pb = (dict(T._leaves(params_to_jax_tree(st.params)))
              for st in (a_state, b_state))
    pj, pj32 = (dict(T._leaves(st.params)) for st in (j_state, j32_state))
    lr = runs["lr"]
    worst = {f"{pair} over {unit}": max(
        (_rms(x[k].astype(np.float64) - y[k]) / max(
            _rms(pj[k].astype(np.float64) - pj32[k]), floor), k)
        for k in pj)
        for pair, x, y in (("A-J", pa, pj), ("A-B", pa, pb))
        for unit, floor in (("the gap", 0.0), ("max(gap, lr)", lr))}
    print(json.dumps({"what": "parameters after three AdamW steps, reduced",
                      "worst rms": worst}))


def full_width(root):
    from pillars_torch.config import Config
    from pillars_torch.data import synthetic
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.loop import forward_backward
    from pillars_torch.weights import from_jax_variables, load_params
    import chip_smoke as cs

    if not os.path.exists(f"{root}/kitti_infos_train.pkl"):
        synthetic.generate_dataset(root, num_train=8, num_test=2, seed=7,
                                   profile="hard")
    cfg = cs._with_split(Config.default(), root)
    batch = cs._train_batches(cfg, 1)[0]
    state_cpu = from_jax_variables(*load_params(str(cs.WEIGHTS)), cfg)
    thr = cfg.train_input.anchor_area_threshold
    cfg_bf = cfg.override("runtime.compute_dtype", "bfloat16")
    out = {}
    for name, c, onednn in (("f32", cfg, True), ("A", cfg_bf, True),
                            ("B", cfg_bf, False)):
        det = PillarsDetector(c, device="cpu")
        with torch.backends.mkldnn.flags(enabled=onednn):
            out[name] = forward_backward(det, cs._train_state(det,
                                                              state_cpu)[0],
                                         batch, thr)
    f, a, b = out["f32"], out["A"], out["B"]
    for field, x, y, z in zip(a.loss._fields, a.loss, b.loss, f.loss):
        x, y, z = float(x), float(y), float(z)
        print(json.dumps({"what": "one-step loss part, full width",
                          "part": field, "A-B/gap": abs(x - y) / abs(x - z),
                          "A-B rel": abs(x - y) / abs(x)}))
    for what, da, db, df in (("gradient leaves", a.grads, b.grads, f.grads),
                             ("new BN statistics", a.batch_stats,
                              b.batch_stats, f.batch_stats)):
        r = sorted((_ratio(da[k], db[k], da[k], df[k]), k) for k in da
                   if da[k].is_floating_point())
        print(json.dumps({"what": f"{what}, full width",
                          "A-B rms over the gap, worst": r[-3:],
                          "median": float(np.median([x for x, _ in r]))}))
    # a CPU proxy of the step's kernel launches: ATen ops of one step
    from torch.profiler import ProfilerActivity, profile

    from pillars_torch.train.loop import make_train_step

    ops = {}
    for c in (cfg, cfg_bf):
        det = PillarsDetector(c, device="cpu")
        state, opt = cs._train_state(det, state_cpu)
        step = make_train_step(det, opt)
        step(state, batch)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, batch)
        ops[c.runtime.compute_dtype] = sum(
            e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    print(json.dumps({"what": "ATen ops of one train step, full width, CPU",
                      **ops}))


def _box_rtol_needed(want, got):
    """The smallest relative box tolerance (over ``BF16_BOX_ATOL``) under
    which ``got``'s valid detections match ``want``'s: each of ``want``'s,
    in descending score order, against the unmatched one of ``got`` of its
    label with the nearest centre, over the six centre and size components
    of the lidar and camera boxes. Returns (that tolerance, detections of
    ``want`` left without a counterpart)."""
    from torch_parity import BF16_BOX_ATOL

    need, missed = 0.0, 0
    wv, gv = np.asarray(want.valid), np.asarray(got.valid)
    for s in range(wv.shape[0]):
        w, g = ({k: np.asarray(getattr(p, k)[s], np.float64)[v]
                 for k in ("boxes_lidar", "boxes_camera", "labels")}
                for p, v in ((want, wv[s]), (got, gv[s])))
        free = np.ones(len(g["labels"]), bool)
        for i in range(len(w["labels"])):
            cand = np.flatnonzero(free & (g["labels"] == w["labels"][i]))
            if not len(cand):
                missed += 1
                continue
            j = cand[np.argmin(np.linalg.norm(
                g["boxes_lidar"][cand, :3] - w["boxes_lidar"][i, :3],
                axis=1))]
            free[j] = False
            for k in ("boxes_lidar", "boxes_camera"):
                d = np.abs(g[k][j, :6] - w[k][i, :6]) - BF16_BOX_ATOL
                need = max(need, float((d / np.abs(w[k][i, :6])).max()))
    return need, missed


def inference():
    """The reduced random-init inference paths of tests/test_torch_bf16.py
    (its inputs): the port's heads (A), the port's with oneDNN's bfloat16
    convs off (B) and the JAX package's (J), in bfloat16 steps apart, and
    the relative box tolerance each pair of predictions needs."""
    import conftest  # noqa: F401  (JAX on the CPU)
    import jax

    import test_torch_bf16 as T
    from pillars_torch.config import Config as TorchConfig
    from pillars_torch.models.detector import PillarsDetector as TD
    from pillars_tpu.config import Config as JaxConfig
    from pillars_tpu.models.detector import PillarsDetector as JD
    from test_torch_second import reduced as reduced_second
    from torch_parity import bf16_steps, d435i_clouds, jit_strict, small_config

    for path in sorted(T.REDUCED_PATHS) + ["second_sparse_d435i",
                                           "second_d435i"]:
        if path.startswith("second"):
            jcfg, tcfg = (reduced_second(c, path)
                          for c in (JaxConfig, TorchConfig))
            n = 1500
        else:
            jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
            for key, value in T.REDUCED_PATHS[path]:
                jcfg, tcfg = (jcfg.override(key, value),
                              tcfg.override(key, value))
            n = 1800
        state, variables = T._random_state(TD(tcfg, device="cpu"), 17)
        pts, num = d435i_clouds(17, 2, jcfg.model.voxel.max_points, n)
        rect, trv2c = T._eye(2)
        jdet = JD(T._bf16_config(jcfg))
        tdet = TD(T._bf16_config(tcfg), device="cpu")
        thr = jcfg.eval_input.anchor_area_threshold
        if path == "point_major_fast":
            import functools

            from pillars_tpu.ops import rpn_pallas
            rpn_pallas.fused_rpn_blocks = functools.partial(
                rpn_pallas.fused_rpn_blocks, interpret=True)

        def jax_run(p, n_, r, t):
            v = jdet.voxelize_batch(p, n_)
            if jdet.dense_cell:
                heads = jdet._forward_dense(variables, p, n_, thr)[0]
            elif path == "point_major_fast":
                heads = jdet._forward_fast(variables, v)
            else:
                heads = jdet.apply(variables, v)
            if path == "point_major_fast":
                amask = jdet.anchors_mask_batch(v.coords, v.pillar_mask, thr)
                preds = jdet.postprocess(heads, amask, r, t)
            else:
                preds = jdet.make_inference_fn()(variables, p, n_, r, t)
            return heads, preds

        jh, jp = jax.device_get(jit_strict(jax_run)(pts, num, rect, trv2c))
        args = tuple(map(torch.from_numpy, (pts, num, rect, trv2c)))

        def port():
            with torch.inference_mode():
                if tdet.dense_cell:
                    heads = tdet._forward_dense(state, *args[:2], thr)[0]
                else:
                    v = tdet.voxelize_batch(*args[:2])
                    heads = (tdet._forward_fast(state, v) if tdet.fast
                             else tdet.apply(state, v))
                return heads, tdet.make_inference_fn()(state, *args)

        ah, ap = port()
        with torch.backends.mkldnn.flags(enabled=False):
            bh, bp = port()
        out = {"what": "bf16 inference, reduced random init", "path": path,
               "onednn_max_cpu_isa": os.environ.get("ONEDNN_MAX_CPU_ISA",
                                                    "default")}
        for pair, x, y, px, py in (("A-J", ah, jh, ap, jp),
                                   ("B-J", bh, jh, bp, jp),
                                   ("A-B", ah, bh, ap, bp)):
            out[f"heads {pair}: share of elements apart"] = max(
                float((bf16_steps(x[k], y[k]) > 0).mean()) for k in jh)
            need, missed = _box_rtol_needed(py, px)
            out[f"box rtol needed {pair}"] = need
            out[f"unmatched {pair}"] = missed
        print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3, 4])
    p.add_argument("--full-width", action="store_true")
    p.add_argument("--networks", action="store_true",
                   help="the four networks' train-mode forward only")
    p.add_argument("--inference", action="store_true",
                   help="the reduced bf16 inference paths only")
    p.add_argument("--root", default=None,
                   help="--full-width: directory of the generated split")
    args = p.parse_args(argv)
    torch.set_num_threads(2)
    if args.full_width:
        if not args.root:
            p.error("--full-width needs --root")
        full_width(args.root)
    elif args.networks:
        networks()
    elif args.inference:
        inference()
    else:
        reduced(args.seeds)


if __name__ == "__main__":
    main()
