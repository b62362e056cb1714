"""Seeded synthetic-data convergence runs, shared by the CPU smoke test
(tests/test_train.py) and the multi-seed A/B harness
(scripts/convergence_ab.py).

The reference has no automated accuracy tests (SURVEY.md §4); these
learnable synthetic sets are this framework's stand-in until the real
ShapeNet/S3DIS runbook (scripts/reproduce.py) can be executed where the
data exists. Two recipes:

- ShapeNet-style part segmentation: per-category Gaussian clusters with
  z-split part labels (same construction as
  data/shapenet.py::write_synthetic) driven through raw
  make_train_step/make_eval_step — fast, no filesystem.
- S3DIS-style block segmentation: data/s3dis.py::write_synthetic
  (z-correlated labels) driven through the real S3DISTrainer, so the
  whole trainer path (masking, dihedral augmentation, x10 siamese) is
  under test.
"""

from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import jax


def learnable_shapenet(rng, n_samples, n_points, n_cat=4, parts_per=3,
                       centers=None):
    """In-memory learnable synthetic part-seg set (z-split part labels
    within per-category Gaussian clusters).

    ``centers``: reuse existing category cluster centers (a continuation
    draw from the same rng stays in-distribution with the first draw —
    a fresh call would place categories at new locations)."""
    xs, segs, cats = [], [], []
    if centers is None:
        centers = rng.standard_normal((n_cat, 3)) * 2.0
    for _ in range(n_samples):
        c = int(rng.integers(0, n_cat))
        pts = centers[c] + rng.standard_normal((n_points, 3)) * 0.5
        z = pts[:, 2]
        q = np.quantile(z, np.linspace(0, 1, parts_per + 1)[1:-1])
        part = np.searchsorted(q, z)
        xs.append(pts.astype(np.float32))
        segs.append((c * parts_per + part).astype(np.int32))
        cats.append(c)
    return np.stack(xs), np.stack(segs), np.asarray(cats, np.int32), centers


def shapenet_train_and_eval_miou(compute_dtype, *, seed=0,
                                 epochs=24, static_graph=False,
                                 data_seed=None, eval_tail=1,
                                 n_points=1024, bs=8):
    """Seeded ShapeNet-style end-to-end training run -> final val
    per-shape mIoU.

    ``seed`` drives the training stochasticity (init, batch order, label
    masks, dropout); ``data_seed`` (default: same as ``seed``) drives the
    dataset draw. The round-4 A/B coupled them and its band was dominated
    by DATASET difficulty, not kernel behavior: seeds 3-4 drew sets on
    which every config half-converged (see docs/kernels.md round 5
    "reconditioned convergence recipe" — the diagnosis runs that located
    the variance on the data axis). Config A/Bs (scripts/convergence_ab.py)
    now pin ``data_seed=0`` (a verified-learnable draw) and vary only
    ``seed``, so the paired config differences measure the config
    rather than draw difficulty.

    ``eval_tail``: average the val mIoU over the final ``eval_tail``
    epochs instead of evaluating only the last checkpoint. With the draw
    pinned, single-run spread is dominated by WHERE on the noisy
    converged plateau the final epoch happens to land; averaging the
    plateau tail measures the plateau itself (round-5 calibration data
    in docs/kernels.md). Requires ``data_seed`` (the val extension must
    be drawn before training, which in coupled mode would perturb the
    training rng stream)."""
    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.metrics.iou import eval_iou
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.train.steps import (
        make_eval_step,
        make_train_step,
    )
    from weaksuppointcloudseg_tpu.utils.tools import onehot_encode

    n_cat, parts_per = 4, 3  # n_points/bs: kwargs (1024/8 = calibrated
    # recipe; smaller values are for fast CPU smoke tests only)
    n_cls = n_cat * parts_per
    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, num_points=n_points, num_classes=n_cls,
            num_categories=n_cat, compute_dtype=compute_dtype,
            static_graph=static_graph),
        train=dataclasses.replace(cfg.train, batch_size=bs, style="Full"),
    )
    rng = np.random.default_rng(seed)
    # ONE generation, split train/val: learnable_shapenet draws fresh
    # category cluster centers per call, so two calls produce val shapes
    # at entirely different locations — out-of-distribution for a model
    # fed absolute xyz (this exact bug made every eval here ~chance).
    data_rng = rng if data_seed is None else np.random.default_rng(data_seed)
    xs_all, segs_all, cats_all, centers = learnable_shapenet(
        data_rng, 64, n_points, n_cat, parts_per)
    xs, segs, cats = xs_all[:48], segs_all[:48], cats_all[:48]
    vx, vseg, vcat = xs_all[48:], segs_all[48:], cats_all[48:]

    if eval_tail > 1 and data_seed is None:
        raise ValueError("eval_tail > 1 requires data_seed (decoupled "
                         "draw): the val extension must be drawn before "
                         "training starts")

    def extend_val():
        # Extended val set (round 5): drawn AFTER training (tail=1) so
        # both the 64-sample base draw (hence the 48-sample TRAIN split)
        # and the training rng stream stay bit-identical to earlier
        # rounds in either data_seed mode; the draw continues around the
        # SAME category centers so it is in-distribution. 16 -> 96 val
        # shapes cuts the eval-side standard error ~2.4x; the measured
        # cross-seed spread barely moved (same runs, both val sets:
        # fast sd 0.0375 -> 0.0361), locating the residual variance on
        # the TRAJECTORY axis — hence eval_tail (docs/kernels.md round
        # 5 "reconditioned convergence recipe"). With eval_tail > 1 the
        # extension is
        # drawn up front instead — safe because data_seed decouples
        # data_rng from the training stream, and the data_rng call
        # sequence (64 then 80) is unchanged.
        exs, esegs, ecats, _ = learnable_shapenet(
            data_rng, 80, n_points, n_cat, parts_per, centers=centers)
        return (np.concatenate([vx, exs]), np.concatenate([vseg, esegs]),
                np.concatenate([vcat, ecats]))

    if eval_tail > 1:
        vx, vseg, vcat = extend_val()

    state = create_train_state(jax.random.PRNGKey(seed), cfg)
    step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)

    def eval_miou(state):
        ious = []
        for lo in range(0, len(vx), bs):
            vb = {
                "data": vx[lo:lo + bs],
                "seg_onehot": onehot_encode(vseg[lo:lo + bs], n_cls),
                "mask": np.ones(vseg[lo:lo + bs].shape, np.float32),
                "cat_onehot": onehot_encode(vcat[lo:lo + bs], n_cat),
            }
            prob, _ = eval_step(state, jax.device_put(vb))
            pred = np.argmax(np.asarray(prob), -1)
            for i in range(pred.shape[0]):
                oids = list(range(vcat[lo + i] * parts_per,
                                  (vcat[lo + i] + 1) * parts_per))
                ious.append(eval_iou(pred[i], vseg[lo + i], oids))
        return float(np.mean(ious))

    key = jax.random.PRNGKey(seed + 1)
    gate = np.float32(1.0)
    tail_mious = []
    for ep in range(epochs):
        order = rng.permutation(len(xs))
        for lo in range(0, len(xs) - bs + 1, bs):
            sel = order[lo:lo + bs]
            # Siamese duplication (each sample twice, interleaved)
            dup = np.repeat(sel, 2)
            seg = segs[dup]
            batch = jax.device_put({
                "data": xs[dup],
                "seg": seg,
                "seg_onehot": onehot_encode(seg, n_cls),
                "mask": (rng.uniform(size=seg.shape) < 0.2).astype(
                    np.float32),
                "cat_onehot": onehot_encode(cats[dup], n_cat),
                "valid": np.ones((2 * bs,), np.float32),
            })
            key, sub = jax.random.split(key)
            state, metrics = step(state, batch, gate, sub)
        if eval_tail > 1 and ep >= epochs - eval_tail:
            tail_mious.append(eval_miou(state))
    float(metrics["total"])  # sync (scalar fetch — CLAUDE.md gotchas)

    if eval_tail > 1:
        return float(np.mean(tail_mious))
    vx, vseg, vcat = extend_val()
    return eval_miou(state)


def s3dis_train_and_eval_miou(compute_dtype, *, seed=0,
                              epochs=24, static_graph=False,
                              data_dir=None):
    """Seeded S3DIS-style trainer run -> final val mIoU (13-fold recipe
    scaled down: 6 rooms/area, 1024-pt blocks, bs=8, rampup 2)."""
    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.data import s3dis
    from weaksuppointcloudseg_tpu.train.loop import S3DISTrainer

    owned = None
    if data_dir is None:
        owned = tempfile.TemporaryDirectory(prefix="wspc_s3c_")
        data_dir = owned.name
    try:
        s3dis.write_synthetic(data_dir, num_rooms_per_area=6,
                              blocks_per_room=8, num_points=1024,
                              areas=(1, 5), seed=0)
        cfg = configs.s3dis_config()
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(
                cfg.model, num_points=1024, compute_dtype=compute_dtype,
                static_graph=static_graph),
            train=dataclasses.replace(cfg.train, batch_size=8, style="Full",
                                      rampup=2),
            weaksup=dataclasses.replace(cfg.weaksup, rampup=2),
        )
        tr = S3DISTrainer(cfg, s3dis.S3DISDataset(data_dir), None,
                          test_area=5, seed=seed)
        for ep in range(epochs):
            tr.train_epoch(ep)
        _, acc, miou, _ = tr.evaluate()
        return float(miou), float(acc)
    finally:
        if owned is not None:
            owned.cleanup()
