#!/usr/bin/env python3
"""End-to-end smoke test of both DGCNN flagships on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: data-parallel train step and
                                   # point-sharded label propagation, each
                                   # against the same work on one card

Phases (one card), each failing loudly:

1. device: the first JAX device must be a GPU;
2. ShapeNet at full width (k=20, edge channels 64, global 1024, transform
   net, 16 categories / 50 part classes, 2048 points): synthetic data
   written by ``data/shapenet.py::write_synthetic``, trained one epoch
   through ``cli.train_shapenet`` at bs=32 (64 clouds per step: Siamese
   pairs) in float32 and in bfloat16, then ``cli.test_shapenet`` with the
   3000-point test views and label propagation (LP);
3. S3DIS at full width (4096-point blocks, bs=14) through
   ``cli.train_s3dis``, then ``cli.test_s3dis`` with per-block LP and with
   ``--RoomLP`` over a 32-block (131,072-point) room;
4. numerics: a float32 forward on the GPU against the same forward on the
   CPU at ``precision="highest"``, the precision the float32 convs get on
   the card, and a bfloat16 train step's gradients against float32's;
5. the fused kNN kernel (ops/knn_pallas.py) against the plain reference
   ``knn_graph`` at the train, test and loss shapes, with both times.

The last line of standard output is one JSON object: ``{"ok": true,
"device": {...}}``. Any failure raises, so the script exits non-zero and
prints no such line. Work files go to ``.smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")

# Tolerances, each with its reason. DGCNN is discontinuous: a rounding
# change can flip a kNN neighbour or a max-pool winner. So two runs that
# differ only in rounding are compared against the spread the model itself
# shows when its input moves by a comparable relative amount ("floor",
# measured in the same run at precision="highest").
# Forward, GPU vs CPU, both at precision="highest": only summation order
# differs (like a 1e-6 input perturbation); relative L2 error of logits.
FWD_HIGHEST_FLOORS = 3.0
FWD_HIGHEST_MIN = 1e-4
# Forward at the default precision: float32 matmuls may run in TF32
# (2^-11 relative per operand, like a 1e-3 input perturbation).
FWD_DEFAULT_FLOORS = 3.0
# bf16 vs f32 gradients. The failure this guards is identically zero
# gradients upstream of a k-max, so every leaf must be finite and non-zero.
# Leaf directions upstream of the kNN graphs are chaotic: in float32 alone,
# a 1e-3 relative input perturbation (smaller than bf16 rounding) already
# decorrelates the transform-branch gradients (cosine ~0.1), so per-leaf
# cosines there prove nothing. What must hold: the losses agree to bf16
# accuracy, every weight/BN leaf has a gradient of the same size, and the
# output layer (no kNN between it and the loss) points the same way.
# BN-absorbed conv biases have no true gradient (noise on both sides) and
# are only checked for being finite and non-zero.
GRAD_LOSS_REL = 0.02
GRAD_NORM_RATIO = 3.0
GRAD_COS_OUT = 0.9
# kNN kernel vs reference: indices equal except f32 ties; distances within
# the rounding bound of the |q|^2 - 2 q.c + |c|^2 formula
KNN_TIE_ULPS = 64
# --multi: four-card step vs one card, both at full f32. Reductions run in
# another order, like a 1e-6 input perturbation, which can flip a few
# neighbours; gradients are sums of many per-point terms that cancel, so a
# flip moves them by percents. So each loss and each gradient leaf must be
# within a few "floors" of one card (the largest move of DP_NUDGES runs
# with the input nudged by 1e-6), and the whole gradient's norm must match
# (a lost or doubled all-reduce moves it by 4x).
DP_NUDGES = 3
DP_FLOORS = 3.0
DP_LOSS_REL = 1e-4
DP_GRAD_MIN = 1e-3
DP_GRAD_NORM = 0.1
LP_MAX_ABS = 1e-2
LP_ARGMAX_AGREE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1

def phase_device(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs} (platform "
                         f"{devs[0].platform!r})")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devs)}")
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}  jax {jax.__version__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(line.strip())   # card name, power limit
    return devs


# ------------------------------------------------------- phases 2 and 3

def _newest_result_dir(dataset: str) -> str:
    dirs = glob.glob(os.path.join(WORK, "Results", dataset, "*"))
    check(bool(dirs), f"no {dataset} result dir written")
    return max(dirs, key=os.path.getmtime)


def _read_metrics(rdir: str) -> dict:
    out = {}
    with open(os.path.join(rdir, "Summary", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["event"]] = rec
    return out


def _check_trained(rdir: str, cfg, keys) -> str:
    """Finite losses and mIoU in the run's metrics; parameters moved."""
    import jax
    import numpy as np

    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.utils.checkpoint import restore_checkpoint

    m = _read_metrics(rdir)
    for event, names in keys.items():
        for name in names:
            v = m[event][name]
            check(np.isfinite(v), f"{event}.{name} = {v} is not finite")
    log("  train: " + "  ".join(
        f"{k}={m['train_epoch'][k]:.4f}" for k in keys["train_epoch"]))
    log("  eval:  " + "  ".join(
        f"{k}={m['eval'][k]:.4f}" for k in keys["eval"]))

    ckpt = os.path.join(rdir, "Checkpoint", "Checkpoint_epoch-best.npz")
    init = create_train_state(jax.random.PRNGKey(0), cfg)
    tree = restore_checkpoint(ckpt, {
        "params": init.params, "bn_state": init.bn_state,
        "opt_state": init.opt_state, "step": init.step,
        "epoch": np.asarray(0)})
    before = jax.tree_util.tree_leaves(init.params)
    after = jax.tree_util.tree_leaves(tree["params"])
    moved = sum(not np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(before, after))
    log(f"  {int(tree['step'])} steps; {moved}/{len(before)} parameter "
        "leaves changed")
    check(int(tree["step"]) >= 2, "fewer than 2 train steps ran")
    check(moved >= 0.9 * len(before), "parameters did not change")
    return ckpt


def phase_shapenet(sizes) -> dict:
    import numpy as np

    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.cli import test_shapenet, train_shapenet
    from weaksuppointcloudseg_tpu.data import shapenet

    data = os.path.join(WORK, "ShapeNet")
    shapenet.write_synthetic(
        data, num_categories=16, parts_per_category=shapenet.SHAPENET_PARTS,
        train_samples=3 * sizes["sn_bs"], val_samples=sizes["sn_bs"],
        test_samples=8, num_points=sizes["sn_points"])
    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_points=sizes["sn_points"]))
    keys = {"train_epoch": ("total", "seg", "siamese", "inexact", "smooth",
                            "acc"),
            "eval": ("loss", "perdata_miou", "pershape_miou")}
    out = {}
    for precision in ("float32", "bfloat16"):
        log(f"[shapenet] train_shapenet -sty Full -bs {sizes['sn_bs']} "
            f"--Precision {precision}")
        t0 = time.perf_counter()
        train_shapenet.main([
            "-sty", "Full", "-bs", str(sizes["sn_bs"]), "--Epoch", "1",
            "--ExpRslt", "1", "-rp", "0", "--Precision", precision,
            "--DataPath", data])
        log(f"  wall {time.perf_counter() - t0:.1f} s (compile included)")
        out[precision] = _check_trained(
            _newest_result_dir("ShapeNet"), cfg, keys)
    log("[shapenet] test_shapenet (3000-point views, factored-CG LP)")
    t0 = time.perf_counter()
    res = test_shapenet.main([
        "--Checkpoint", out["float32"], "--DataPath", data,
        "--batchsize", str(sizes["sn_bs"]),
        "--num_points", str(sizes["sn_test_points"])])
    log(f"  wall {time.perf_counter() - t0:.1f} s")
    for k in ("perdata_miou", "pershape_miou", "accuracy"):
        check(np.isfinite(res[k]), f"test {k} = {res[k]} is not finite")
    return out


def phase_s3dis(sizes) -> None:
    import numpy as np

    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.cli import test_s3dis, train_s3dis
    from weaksuppointcloudseg_tpu.data import s3dis

    data = os.path.join(WORK, "S3DIS")
    # one room per area; an 8 m x 4 m room holds 32 one-metre blocks, so
    # the Area-5 test room is 32 x 4096 = 131,072 points for room LP
    s3dis.write_synthetic(
        data, num_rooms_per_area=1, areas=(1, 5),
        blocks_per_room=sizes["s3_blocks"], num_points=sizes["s3_points"],
        room_xy=sizes["s3_room_xy"])
    cfg = configs.s3dis_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_points=sizes["s3_points"]))
    log(f"[s3dis] train_s3dis -sty Full -bs {sizes['s3_bs']}")
    t0 = time.perf_counter()
    train_s3dis.main([
        "-sty", "Full", "-bs", str(sizes["s3_bs"]), "--Epoch", "1",
        "--ExpRslt", "1", "-rp", "0", "-ta", "5", "--DataPath", data])
    log(f"  wall {time.perf_counter() - t0:.1f} s (compile included)")
    ckpt = _check_trained(
        _newest_result_dir("S3DIS"), cfg,
        {"train_epoch": ("total", "seg", "siamese", "inexact", "smooth",
                         "acc"),
         "eval": ("loss", "miou")})
    for room_lp in (False, True):
        what = "--RoomLP (whole room)" if room_lp else "per-block LP"
        log(f"[s3dis] test_s3dis {what}")
        t0 = time.perf_counter()
        res = test_s3dis.main(
            ["--Checkpoint", ckpt, "--DataPath", data, "-ta", "5",
             "--batchsize", str(sizes["s3_bs"])]
            + (["--RoomLP"] if room_lp else []))
        log(f"  wall {time.perf_counter() - t0:.1f} s")
        check(np.isfinite(res["miou"]) and np.isfinite(res["accuracy"]),
              f"test_s3dis {what}: non-finite mIoU/accuracy {res}")
    rooms = glob.glob(os.path.join(data, "rooms", "Area_5_*.npy"))
    n = int(sum(len(np.load(r)) for r in rooms))
    log(f"  Area-5 raw room points: {n}; LP points: "
        f"{sizes['s3_blocks']} x {sizes['s3_points']}")


# ---------------------------------------------------------------- phase 4

def _rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _perturbed_params(cfg, seed: int = 0):
    """Random init with a non-zero transform-net output layer: the
    reference zero-initialises it, which blocks every gradient into the
    transform branch at step 0."""
    import jax

    from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg

    params, bn_state = init_dgcnn_seg(jax.random.PRNGKey(seed), cfg.model)
    tn = dict(params["transform_net"])
    w = tn["transform_out"]["w"]
    tn["transform_out"] = dict(
        tn["transform_out"],
        w=0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1), w.shape))
    return dict(params, transform_net=tn), bn_state


def phase_numerics(sizes) -> None:
    import jax
    import numpy as np

    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.data import shapenet
    from weaksuppointcloudseg_tpu.models import layers
    from weaksuppointcloudseg_tpu.train.loop import ShapeNetTrainer
    from weaksuppointcloudseg_tpu.train.steps import _loss_fn, make_forward_fn

    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_points=sizes["sn_points"]))
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]

    # -- which precision the float32 preset's convs get on the card
    rng = np.random.default_rng(0)
    p, _ = layers.init_conv(jax.random.PRNGKey(0), 128, 64, bn=False)
    h = rng.standard_normal((16, 512, 20, 128)).astype(np.float32)
    conv = jax.jit(lambda p, h: layers.apply_conv(
        p, {}, h, training=True, relu=False, bn=False)[0])
    y = np.asarray(conv(p, h))
    y64 = h.astype(np.float64) @ np.asarray(p["w"], np.float64) + np.asarray(
        p["b"], np.float64)
    err = _rel_l2(y, y64)
    kind = "TF32" if err > 1e-5 else "full float32"
    log(f"[numerics] float32 conv at default precision on the GPU: relative "
        f"L2 error vs float64 {err:.2e} -> {kind}")

    # -- float32 forward: GPU vs CPU at highest precision
    params, bn_state = _perturbed_params(cfg)
    b = sizes["fwd_batch"]
    x = (0.3 * rng.standard_normal(
        (b, sizes["sn_points"], 3))).astype(np.float32)
    cat = np.eye(cfg.model.num_categories, dtype=np.float32)[
        rng.integers(0, cfg.model.num_categories, b)]
    forward = make_forward_fn(cfg)

    def fwd(params, bn_state, x, cat):
        return forward(params, bn_state, x, cat, training=False,
                       bn_decay=None, rng=jax.random.PRNGKey(0))[0]

    def nudged(eps):
        return (x * (1 + eps * rng.standard_normal(x.shape))).astype(
            np.float32)

    fwd_gpu = jax.jit(fwd, device=gpu)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(fwd, device=cpu)(params, bn_state, x, cat))
        got_hi = np.asarray(fwd_gpu(params, bn_state, x, cat))
        floor6, floor3 = (
            _rel_l2(fwd_gpu(params, bn_state, nudged(eps), cat), got_hi)
            for eps in (1e-6, 1e-3))
    got_def = np.asarray(jax.jit(fwd, device=gpu)(params, bn_state, x, cat))
    e_hi, e_def = _rel_l2(got_hi, want), _rel_l2(got_def, want)
    lim_hi = max(FWD_HIGHEST_FLOORS * floor6, FWD_HIGHEST_MIN)
    lim_def = FWD_DEFAULT_FLOORS * floor3
    agree = float(np.mean(got_def.argmax(-1) == want.argmax(-1)))
    log(f"[numerics] f32 forward B={b} N={sizes['sn_points']}, logits rel "
        f"L2: GPU(highest) vs CPU(highest) {e_hi:.2e} (limit {lim_hi:.2e}; "
        f"floor at 1e-6 input nudge {floor6:.2e}); GPU(default) vs "
        f"CPU(highest) {e_def:.2e} (limit {lim_def:.2e}; floor at 1e-3 "
        f"nudge {floor3:.2e}); argmax agreement {agree:.4f}")
    check(np.isfinite(got_def).all() and np.isfinite(got_hi).all(),
          "non-finite GPU logits")
    check(e_hi <= lim_hi, "GPU(highest) forward disagrees with the CPU")
    check(e_def <= lim_def, "GPU(default) forward disagrees with the CPU")

    # -- bf16 vs f32 gradients on one real Full-style batch
    ds = shapenet.ShapeNetDataset(os.path.join(WORK, "ShapeNet"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=ds.meta.num_part_cats,
        num_categories=ds.meta.num_categories))
    params, bn_state = _perturbed_params(cfg)
    tr = ShapeNetTrainer(cfg, ds, None, seed=0)
    batch = tr._assemble(next(ds.batches("train", sizes["sn_bs"])),
                         siamese=True, augment_pairs=True, full_mask=False)
    losses, grads = {}, {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype))
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, batch, c=c: _loss_fn(
                p, bn_state, batch, cfg=c, style="Full", bn_decay=0.5,
                gate=1.0, rng=jax.random.PRNGKey(1)),
            has_aux=True))(params, batch)
        losses[dtype] = float(loss)
        grads[dtype] = [(jax.tree_util.keystr(k), np.asarray(v, np.float64))
                        for k, v in jax.tree_util.tree_leaves_with_path(g)]
    loss_rel = abs(losses["bfloat16"] - losses["float32"]) / abs(
        losses["float32"])
    ratios, cos_out = [], []
    for (name, a), (_, bb) in zip(grads["float32"], grads["bfloat16"]):
        for tag, v in (("f32", a), ("bf16", bb)):
            check(np.isfinite(v).all(), f"{tag} gradient {name} not finite")
            check(np.any(v != 0), f"{tag} gradient {name} is all zero")
        if not name.endswith("['b']") or "_out" in name:
            ratios.append((np.linalg.norm(bb) / np.linalg.norm(a), name))
        if "seg_out" in name:
            cos_out.append(float(a.ravel() @ bb.ravel() / (
                np.linalg.norm(a) * np.linalg.norm(bb))))
    lo, hi = min(ratios), max(ratios)
    log(f"[numerics] bf16 vs f32 train step on one Full batch: loss "
        f"{losses['bfloat16']:.5f} vs {losses['float32']:.5f} (rel "
        f"{loss_rel:.2e}, limit {GRAD_LOSS_REL}); all {len(ratios)} + "
        f"{len(grads['float32']) - len(ratios)} gradient leaves finite and "
        f"non-zero; |g_bf16|/|g_f32| in [{lo[0]:.3f} ({lo[1]}), "
        f"{hi[0]:.3f} ({hi[1]})] (limit x/{GRAD_NORM_RATIO:g}); output "
        f"layer cosines {', '.join(f'{c:.4f}' for c in cos_out)} (limit "
        f"{GRAD_COS_OUT})")
    check(loss_rel <= GRAD_LOSS_REL, "bf16 loss disagrees with f32")
    check(1 / GRAD_NORM_RATIO <= lo[0] and hi[0] <= GRAD_NORM_RATIO,
          "bf16 gradient sizes disagree with f32")
    check(min(cos_out) >= GRAD_COS_OUT, "bf16 output-layer gradient differs")


# ---------------------------------------------------------------- phase 5

def _time_ms(fn, *args, reps: int = 5) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_knn(sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from weaksuppointcloudseg_tpu.ops.knn_pallas import knn_pallas
    from weaksuppointcloudseg_tpu.ops.neighbors import (
        knn_graph,
        pairwise_sqdist,
    )

    rng = np.random.default_rng(0)
    for b, n, c, k in sizes["knn_shapes"]:
        x = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32)
        kern = jax.jit(lambda x, k=k: knn_pallas(x, k, with_values=True))
        ref = jax.jit(lambda x, k=k: knn_graph(x, k))
        idx, vals = (np.asarray(a) for a in kern(x))
        want = np.asarray(ref(x))
        d = np.asarray(jax.jit(pairwise_sqdist)(x))
        sq = np.asarray(jnp.sum(jnp.square(x), -1))
        tol = KNN_TIE_ULPS * np.finfo(np.float32).eps * (
            sq[..., None] + sq.max(-1)[:, None, None])
        d_got = np.take_along_axis(d, idx, -1)
        d_want = np.take_along_axis(d, want, -1)
        mism = idx != want
        bad = int((mism & (np.abs(d_got - d_want) > tol)).sum())
        val_bad = int((np.abs(vals - d_got) > tol).sum())
        t_k, t_x = _time_ms(kern, x), _time_ms(ref, x)
        log(f"[knn] B={b} N={n} C={c} k={k}: kernel {t_k:.3f} ms, XLA "
            f"{t_x:.3f} ms; index mismatches {int(mism.sum())} (all f32 "
            f"ties: {bad == 0}), distance errors {val_bad}")
        check(bad == 0, f"{bad} kNN indices differ beyond f32 ties")
        check(val_bad == 0, f"{val_bad} kNN distances off")


# ----------------------------------------------------------- --multi

def phase_multi(sizes) -> None:
    import jax

    from weaksuppointcloudseg_tpu.parallel import make_mesh

    n_dev = 4
    mesh = make_mesh(n_dev, devices=jax.devices()[:n_dev])
    # TF32 rounding depends on the GEMM shapes, which differ between the
    # one-card (all clouds) and the four-card (a quarter each) programs:
    # compare at full f32, where only the summation order differs
    with jax.default_matmul_precision("highest"):
        _compare_multi(sizes, mesh, n_dev)


def _compare_multi(sizes, mesh, n_dev) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.parallel import replicate, shard_batch
    from weaksuppointcloudseg_tpu.propagate.label_prop import propagate_batch
    from weaksuppointcloudseg_tpu.propagate.sharded import (
        label_propagation_sharded,
    )
    from weaksuppointcloudseg_tpu.train.steps import _loss_fn
    from weaksuppointcloudseg_tpu.utils.tools import onehot_encode

    # -- Full-style ShapeNet step: 4-card data parallelism vs one card
    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_points=sizes["sn_points"]))
    params, bn_state = _perturbed_params(cfg)
    rng = np.random.default_rng(0)
    b, n, nc = 2 * sizes["sn_bs"], sizes["sn_points"], cfg.model.num_classes
    seg = rng.integers(0, nc, (b, n))
    pts = (0.3 * rng.standard_normal((b // 2, n, 3))).astype(np.float32)
    batch = {
        "data": np.repeat(pts, 2, axis=0)
        + 0.01 * rng.standard_normal((b, n, 3)).astype(np.float32),
        "seg": seg.astype(np.int32),
        "seg_onehot": onehot_encode(seg, nc),
        "mask": (rng.uniform(size=(b, n)) < 0.1).astype(np.float32),
        "cat_onehot": onehot_encode(
            np.repeat(rng.integers(0, cfg.model.num_categories, b // 2), 2),
            cfg.model.num_categories),
        "valid": np.ones((b,), np.float32),
    }
    # threefry keys: dropout bits do not depend on how the batch is split
    key = jax.random.key(1, impl="threefry2x32")

    def loss_and_grads(params, bn_state, batch, key):
        (loss, (comps, _, _)), g = jax.value_and_grad(
            _loss_fn, has_aux=True)(
            params, bn_state, batch, cfg=cfg, style="Full", bn_decay=0.5,
            gate=jnp.float32(1.0), rng=key)
        return comps, g

    step = jax.jit(loss_and_grads)
    dev0 = jax.devices()[0]
    args1 = (params, bn_state, jax.device_put(batch, dev0), key)
    args4 = (replicate(params, mesh), replicate(bn_state, mesh),
             shard_batch(batch, mesh, pair_interleaved=True), key)

    def nudged(seed):
        eps = 1e-6 * np.random.default_rng(seed).standard_normal(
            batch["data"].shape)
        data = (batch["data"] * (1 + eps)).astype(np.float32)
        return (params, bn_state, jax.device_put(dict(batch, data=data),
                                                 dev0), key)

    one = step(*args1)
    floors = [step(*nudged(s)) for s in range(DP_NUDGES)]
    four = step(*args4)
    log(f"[multi] loss+gradient step (full f32), {b} clouds x {n} points: "
        f"1 card {_time_ms(step, *args1):.3f} ms, {n_dev} cards "
        f"{_time_ms(step, *args4):.3f} ms")
    (c1, g1), (c4, g4) = jax.tree_util.tree_map(np.asarray, (one, four))
    floors = jax.tree_util.tree_map(np.asarray, floors)

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)

    for name in c1:
        err = rel(c4[name], c1[name])
        fl = max(rel(c[name], c1[name]) for c, _ in floors)
        lim = max(DP_FLOORS * fl, DP_LOSS_REL)
        log(f"[multi] loss {name}: 1 card {float(c1[name]):.6f}, 4 cards "
            f"{float(c4[name]):.6f} (rel {err:.2e}; nudge floor {fl:.2e}; "
            f"limit {lim:.2e})")
        check(err <= lim, f"4-card {name} loss disagrees")
    l1 = jax.tree_util.tree_leaves_with_path(g1)
    l4 = jax.tree_util.tree_leaves(g4)
    lf = [jax.tree_util.tree_leaves(g) for _, g in floors]
    # conv biases followed by BN have no true gradient (noise on both
    # sides): they count only in the whole-gradient norm
    worst = (-1.0, "", 0.0, 0.0)
    for i, ((k, a1), a4) in enumerate(zip(l1, l4)):
        name = jax.tree_util.keystr(k)
        if name.endswith("['b']") and "_out" not in name:
            continue
        err = _rel_l2(a4, a1)
        fl = max(_rel_l2(f[i], a1) for f in lf)
        excess = err / max(DP_FLOORS * fl, DP_GRAD_MIN)
        worst = max(worst, (excess, name, err, fl))
    n1 = np.sqrt(sum(float(np.sum(np.square(a))) for _, a in l1))
    n4 = np.sqrt(sum(float(np.sum(np.square(a))) for a in l4))
    log(f"[multi] gradients: |g_4|/|g_1| {n4 / n1:.5f} (limit 1 +- "
        f"{DP_GRAD_NORM}); worst leaf {worst[1]}: rel L2 {worst[2]:.2e} vs "
        f"its nudge floor {worst[3]:.2e} (limit max({DP_FLOORS:g} floors, "
        f"{DP_GRAD_MIN:g}))")
    check(abs(n4 / n1 - 1) <= DP_GRAD_NORM, "4-card gradient norm differs")
    check(worst[0] <= 1.0, f"4-card gradient {worst[1]} differs")

    # -- point-sharded LP vs single-card factored CG (full f32 too)
    lb, ln, lk = sizes["lp_shape"]
    xyz = rng.standard_normal((lb, ln, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True).max(1, keepdims=True)
    g = np.asarray(jax.nn.softmax(
        jnp.asarray(rng.standard_normal((lb, ln, lk)) * 3.0), -1))
    ref = np.asarray(propagate_batch(jnp.asarray(xyz), jnp.asarray(g),
                                     solver="cg"))
    got = np.asarray(label_propagation_sharded(
        mesh, jnp.asarray(xyz), jnp.asarray(g)))
    diff = float(np.abs(got - ref).max())
    agree = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    log(f"[multi] sharded LP over {n_dev} cards vs 1-card factored CG at "
        f"B={lb} N={ln} K={lk}: max |dP| {diff:.2e} (limit {LP_MAX_ABS:g}), "
        f"argmax agreement {agree:.4f} (limit {LP_ARGMAX_AGREE})")
    check(np.isfinite(got).all(), "non-finite sharded LP output")
    check(diff <= LP_MAX_ABS and agree >= LP_ARGMAX_AGREE,
          "sharded LP disagrees with factored CG")


SIZES = {
    "sn_bs": 32, "sn_points": 2048, "sn_test_points": 3000,
    "s3_bs": 14, "s3_points": 4096, "s3_blocks": 32,
    "s3_room_xy": (8.0, 4.0), "fwd_batch": 8,
    "lp_shape": (32, 3000, 50),
    "knn_shapes": [
        (64, 2048, 3, 20), (64, 2048, 64, 20),
        (32, 3000, 3, 20), (32, 3000, 64, 20),
        (28, 4096, 3, 20), (28, 4096, 64, 20),
        (64, 2048, 3, 10), (28, 4096, 6, 10),   # smoothness loss
    ],
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="four cards: DP train step and sharded LP only")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    from weaksuppointcloudseg_tpu.utils.compile_cache import (
        init_compile_cache,
    )

    cache = init_compile_cache()
    devs = phase_device(4 if args.multi else 1)
    log(f"compile cache: {cache}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.chdir(WORK)  # the CLIs write ./Results and ./Preprocess
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(SIZES)
    else:
        phase_shapenet(SIZES)
        phase_s3dis(SIZES)
        phase_numerics(SIZES)
        phase_knn(SIZES)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
