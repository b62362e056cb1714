"""Epoch-loop trainers for ShapeNet and S3DIS.

High-level drivers mirroring the reference trainer API surface
(``defineNetwork`` / ``TrainOneEpoch[_Full]`` / ``EvalOneEpoch[_Full]`` /
``Test`` / ``SaveCheckPoint`` / ``RestoreCheckPoint`` —
ShapeNet/ShapeNet_DGCNN_trainer.py:19-644, S3DIS/S3DIS_DGCNN_trainer.py) on
top of the jitted step functions (train/steps.py):

- host side: batch assembly, SampIndex masks, Siamese duplication +
  augmentation (data/augment.py), one-hot encoding — all vectorized numpy;
- device side: one compiled step per config; batches sharded over the data
  mesh (parallel/mesh.py), params replicated;
- eval: training=False population-stats forward (fixes quirk Q7), category-
  biased argmax + per-shape IoU (ShapeNet) or global confusion mIoU (S3DIS);
- test: fixed-size resampling (3000 pts ShapeNet, duplicate-then-slice,
  quirk Q3 fixed) + probabilistic label propagation for the Full style.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import jax
import numpy as np

from weaksuppointcloudseg_tpu.configs import ExperimentConfig
from weaksuppointcloudseg_tpu.data import augment, sampling
from weaksuppointcloudseg_tpu.data import shapenet as shapenet_data
from weaksuppointcloudseg_tpu.data import s3dis as s3dis_data
from weaksuppointcloudseg_tpu.metrics.iou import (
    eval_iou,
    category_biased_argmax,
    ConfusionAccumulator,
)
from weaksuppointcloudseg_tpu.parallel import make_mesh, replicate, shard_batch
from weaksuppointcloudseg_tpu.propagate import propagate_batch
from weaksuppointcloudseg_tpu.train.state import create_train_state
from weaksuppointcloudseg_tpu.train.steps import (
    make_train_step,
    make_eval_step,
    make_eval_logits_fn,
    make_forward_fn,
)
from weaksuppointcloudseg_tpu.utils.checkpoint import CheckpointManager
from weaksuppointcloudseg_tpu.utils.tools import onehot_encode


class _TrainerBase:
    """Shared state / step / checkpoint plumbing."""

    def __init__(self, cfg: ExperimentConfig, *, seed: int = 0,
                 ckpt_dir: Optional[str] = None, num_devices: Optional[int] = None):
        self.cfg = cfg
        self.style = cfg.train.style
        self.rampup = cfg.train.rampup
        self.mesh = make_mesh(num_devices) if (num_devices or 0) > 1 else None
        key = jax.random.PRNGKey(seed)
        self.state = create_train_state(key, cfg)
        if self.mesh is not None:
            self.state = replicate(self.state, self.mesh)
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.forward = make_forward_fn(cfg)
        self.np_rng = np.random.default_rng(seed)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.epoch = 0
        # Per-step stream (dropout masks): cfg.train.rng_impl (configs.py).
        # Param init above stays on the default threefry stream.
        self._step_rng = jax.random.key(
            seed + 1, impl=cfg.train.rng_impl)

    # -- helpers ----------------------------------------------------------

    def _next_rng(self):
        self._step_rng, sub = jax.random.split(self._step_rng)
        return sub

    def _gate(self, epoch: int) -> np.float32:
        return np.float32(1.0 if epoch >= self.rampup else 0.0)

    def _put(self, batch: Dict[str, np.ndarray], *, pairs: bool) -> Dict:
        if self.mesh is None:
            return batch
        return shard_batch(batch, self.mesh, pair_interleaved=pairs)

    # -- checkpointing ----------------------------------------------------

    def _ckpt_tree(self):
        return {
            "params": self.state.params,
            "bn_state": self.state.bn_state,
            "opt_state": self.state.opt_state,
            "step": self.state.step,
            "epoch": np.asarray(self.epoch),
        }

    def save_checkpoint(self, metric: float) -> Optional[str]:
        if self.ckpt is None:
            return None
        return self.ckpt.save(self._ckpt_tree(), self.epoch, metric)

    def restore_checkpoint(self, path: str) -> None:
        from weaksuppointcloudseg_tpu.utils.checkpoint import restore_checkpoint

        tree = restore_checkpoint(path, self._ckpt_tree())
        self.state = self.state.replace(
            params=tree["params"],
            bn_state=tree["bn_state"],
            opt_state=tree["opt_state"],
            step=jax.numpy.asarray(tree["step"]),
        )
        self.epoch = int(tree["epoch"])
        if self.mesh is not None:
            self.state = replicate(self.state, self.mesh)

    # -- shared epoch driver ------------------------------------------------

    def _run_train_epoch(self, batches, epoch, gate, siamese, augment_pairs):
        """Prefetched step loop: batch assembly + H2D run on a background
        thread (data/prefetch.py); per-step metrics stay on device and are
        fetched once at epoch end (a per-step float() would serialize the
        dispatch pipeline)."""
        from weaksuppointcloudseg_tpu.data.prefetch import prefetch

        def assemble(b):
            batch = self._assemble(b, siamese=siamese,
                                   augment_pairs=augment_pairs, full_mask=False)
            return self._put(batch, pairs=siamese), b.valid

        device_metrics, counts = [], []
        for batch, valid in prefetch(batches, depth=2, transform=assemble):
            self.state, metrics = self.train_step(
                self.state, batch, gate, self._next_rng()
            )
            device_metrics.append(metrics)
            counts.append(valid)
        self.epoch = epoch + 1
        if not device_metrics:
            return {}
        stacked = jax.tree_util.tree_map(
            lambda *xs: jax.numpy.stack(xs), *device_metrics
        )
        host = jax.tree_util.tree_map(np.asarray, stacked)  # one sync
        w = np.asarray(counts, np.float64)
        return {k: float(np.sum(v * w) / w.sum()) for k, v in host.items()}


class ShapeNetTrainer(_TrainerBase):
    """ShapeNet part-segmentation trainer (ShapeNet_DGCNN_trainer.py)."""

    def __init__(self, cfg: ExperimentConfig, dataset: shapenet_data.ShapeNetDataset,
                 pts_idx_list=None, **kw):
        super().__init__(cfg, **kw)
        self.ds = dataset
        self.meta = dataset.meta
        self.pts_idx = pts_idx_list  # [num_train_samples, n_labelled] or None
        self.num_classes = cfg.model.num_classes
        self.num_categories = cfg.model.num_categories
        # category -> its part ids, as a binary [num_categories, num_classes]
        # matrix (for the reference's category-biased train argmax)
        self._cat_part_mask = np.zeros(
            (self.num_categories, self.num_classes), np.float32)
        for c in range(min(self.num_categories, len(self.meta.objcats))):
            self._cat_part_mask[c, self.meta.iou_oids(c)] = 1.0

    # -- batch assembly ---------------------------------------------------

    def _assemble(self, b: shapenet_data.Batch, *, siamese: bool,
                  augment_pairs: bool, full_mask: bool) -> Dict[str, np.ndarray]:
        n = b.data.shape[1]
        if full_mask or self.pts_idx is None:
            mask = np.ones((b.data.shape[0], n), np.float32)
        else:
            mask = sampling.indices_to_mask(self.pts_idx, b.sample_ids, n)
        data = b.data
        valid = np.zeros(b.data.shape[0], np.float32)
        valid[: b.valid] = 1.0
        # padded tail rows must not contribute to the masked-CE denominator
        # (the eval loss would otherwise average duplicate samples in)
        mask = mask * valid[:, None]
        if siamese:
            aug = augment.shapenet_augment if augment_pairs else None
            data = augment.make_siamese_batch(data, self.np_rng, aug)
            mask = augment.interleave_duplicate(mask)
            seg = augment.interleave_duplicate(b.seg)
            label = augment.interleave_duplicate(b.label)
            valid = augment.interleave_duplicate(valid)
        else:
            seg, label = b.seg, b.label
        cat_onehot = onehot_encode(label, self.num_categories)
        return {
            "data": data.astype(np.float32),
            "seg": seg.astype(np.int32),
            "seg_onehot": onehot_encode(seg, self.num_classes),
            "mask": mask,
            "cat_onehot": cat_onehot,
            "part_bias": cat_onehot @ self._cat_part_mask,
            "valid": valid,
        }

    # -- epochs -----------------------------------------------------------

    def train_epoch(self, epoch: Optional[int] = None) -> Dict[str, float]:
        """One training epoch; returns averaged metrics."""
        epoch = self.epoch if epoch is None else epoch
        siamese = self.style == "Full"
        gate = self._gate(epoch)
        augment_pairs = siamese and epoch >= self.rampup
        batches = self.ds.batches("train", self.cfg.train.batch_size,
                                  shuffle=True, drop_last=True, rng=self.np_rng)
        return self._run_train_epoch(batches, epoch, gate, siamese, augment_pairs)

    def evaluate(self) -> Tuple[float, float, float, np.ndarray]:
        """Validation pass. Returns (loss, acc, perdata_miou, pershape_miou
        [num_categories]) matching EvalOneEpoch_Full (:421-507)."""
        losses, loss_w, accs, ious = [], [], [], []
        shape_cnt = np.zeros(self.num_categories)
        pershape = np.zeros(self.num_categories)
        for b in self.ds.batches("val", self.cfg.train.batch_size):
            batch = self._assemble(b, siamese=False, augment_pairs=False,
                                   full_mask=True)
            prob, loss = self.eval_step(self.state, self._put(batch, pairs=False))
            prob = np.asarray(prob)[: b.valid]
            # the step's masked CE already excludes padded rows (zeroed
            # mask); weight by valid count so the tail batch isn't
            # over-represented in the epoch average
            losses.append(float(loss))
            loss_w.append(b.valid)
            for b_i in range(b.valid):
                cat = int(b.label[b_i])
                oids = self.meta.iou_oids(cat)
                pred = category_biased_argmax(prob[b_i], oids)
                iou = eval_iou(pred, b.seg[b_i], oids)
                ious.append(iou)
                accs.append(float(np.mean(pred == b.seg[b_i])))
                pershape[cat] = (pershape[cat] * shape_cnt[cat] + iou) / (shape_cnt[cat] + 1)
                shape_cnt[cat] += 1
        return (
            float(np.average(losses, weights=loss_w)) if losses else 0.0,
            float(np.mean(accs)) if accs else 0.0,
            float(np.mean(ious)) if ious else 0.0,
            pershape,
        )

    def test(self, testset: shapenet_data.ShapeNetTestSet, *,
             use_label_prop: Optional[bool] = None,
             num_points: int = 3000,
             batch_size: Optional[int] = None) -> Dict[str, float]:
        """Held-out test with fixed-size resampling + optional LP
        (ShapeNet_DGCNN_trainer.py:511-596).

        Unlike the reference's one-sample-at-a-time session loop, views are
        processed in fixed-size batches — the forward pass AND the LP solve
        are batched on device (~batch_size x inference throughput). Every
        shape is expanded into one or more ``num_points``-sized views that
        together cover all of its points (data/shapenet.py::cover_partition)
        and IoU/accuracy score every ORIGINAL point — shapes larger than
        ``num_points`` (which crash the reference, quirk Q3) are fully
        evaluated, not subsampled.
        """
        if use_label_prop is None:
            use_label_prop = self.style == "Full"
        if batch_size is None:
            batch_size = max(self.cfg.train.batch_size, 1)
        lp = self.cfg.labelprop
        per_data_iou = []
        shape_cnt = np.zeros(self.num_categories)
        pershape = np.zeros(self.num_categories)
        accs = []
        logits_fn = make_eval_logits_fn(self.cfg)
        eval_fwd = jax.jit(
            lambda state, x, cat: jax.nn.softmax(
                logits_fn(state, x, cat), axis=-1)
        )

        shapes: Dict[int, dict] = {}  # shape id -> in-flight buffers
        queue = []  # (shape_id, view index array)

        def finish(sid):
            e = shapes.pop(sid)
            seg, cat = e["seg"], e["cat"]
            oids = self.meta.iou_oids(cat)
            pred = category_biased_argmax(e["prob"], oids)
            iou = eval_iou(pred, seg, oids)
            per_data_iou.append(iou)
            accs.append(float(np.mean(pred == seg)))
            pershape[cat] = (
                pershape[cat] * shape_cnt[cat] + iou) / (shape_cnt[cat] + 1)
            shape_cnt[cat] += 1

        pending = []  # one-batch device lag: (views, valid, device prob)

        def drain():
            views, valid, prob = pending.pop()
            prob = np.asarray(prob)  # the only D2H sync
            for v_i in range(valid):
                sid, sel = views[v_i]
                e = shapes[sid]
                # first estimate wins: original positions beat duplicate
                # padding (the reference keeps Z_prob_LP[pts_idx], the
                # first len(pts) rows) and earlier views beat pad repeats
                uniq, first = np.unique(sel, return_index=True)
                fresh = first[~e["written"][uniq]]
                e["prob"][sel[fresh]] = prob[v_i][fresh]
                e["written"][sel[fresh]] = True
                e["left"] -= 1
                if e["left"] == 0:
                    finish(sid)

        def flush(force=False):
            while queue and (len(queue) >= batch_size or force):
                views = queue[:batch_size]
                del queue[:batch_size]
                valid = len(views)
                xs = [shapes[sid]["pts"][sel] for sid, sel in views]
                cats = [shapes[sid]["cat"] for sid, _ in views]
                while len(xs) < batch_size:  # pad to the compiled shape
                    xs.append(xs[0])
                    cats.append(cats[0])
                x = np.stack(xs).astype(np.float32)
                cat_onehot = onehot_encode(
                    np.asarray(cats), self.num_categories)
                prob = eval_fwd(self.state, x, cat_onehot)
                if use_label_prop:
                    prob = propagate_batch(
                        x, prob,
                        alpha=lp.alpha, beta=lp.beta,
                        xyz_bandwidth=lp.xyz_bandwidth,
                        rgb_bandwidth=lp.rgb_bandwidth,
                        ridge=lp.ridge, solver=lp.solver,
                        cg_iters=lp.cg_iters, cg_tol=lp.cg_tol,
                    )
                # dispatch is async: batch i's D2H fetch + host scatter-back
                # happen while the device runs batch i+1's forward + LP
                # (finish() can free a shape's buffers only AFTER its views
                # drain, so the lag is exactly one batch)
                if pending:
                    drain()
                pending.append((views, valid, prob))

        for i in range(len(testset)):
            pts, seg, cat = testset[i]
            sels = shapenet_data.cover_partition(
                len(pts), num_points, self.np_rng)
            shapes[i] = {
                "pts": pts, "seg": seg, "cat": cat,
                "prob": np.zeros((len(pts), self.num_classes), np.float32),
                "written": np.zeros(len(pts), bool),
                "left": len(sels),
            }
            queue.extend((i, sel) for sel in sels)
            flush()
        flush(force=True)
        if pending:
            drain()
        seen = shape_cnt > 0
        return {
            "perdata_miou": float(np.mean(per_data_iou)),
            "pershape_miou": float(np.mean(pershape[seen])) if seen.any() else 0.0,
            "accuracy": float(np.mean(accs)),
            # per-category table (reference prints it at test time,
            # ShapeNet_DGCNN_trainer.py:584-587); unseen categories are NaN
            "per_category_iou": np.where(seen, pershape, np.nan),
        }


class S3DISTrainer(_TrainerBase):
    """S3DIS semantic-segmentation trainer (S3DIS_DGCNN_trainer.py)."""

    def __init__(self, cfg: ExperimentConfig, dataset: s3dis_data.S3DISDataset,
                 pts_idx_list=None, test_area: int = 5, **kw):
        super().__init__(cfg, **kw)
        self.ds = dataset
        self.pts_idx = pts_idx_list
        self.test_area = test_area
        self.train_idx, self.val_idx = dataset.split_indices(test_area)
        self.num_classes = cfg.model.num_classes

    def _assemble(self, b: s3dis_data.Batch, *, siamese: bool,
                  augment_pairs: bool, full_mask: bool) -> Dict[str, np.ndarray]:
        n = b.data.shape[1]
        if full_mask or self.pts_idx is None:
            mask = np.ones((b.data.shape[0], n), np.float32)
        else:
            mask = sampling.indices_to_mask(self.pts_idx, b.sample_ids, n)
        data = b.data
        valid = np.zeros(b.data.shape[0], np.float32)
        valid[: b.valid] = 1.0
        # padded tail rows must not contribute to the masked-CE denominator
        mask = mask * valid[:, None]
        if siamese:
            aug = augment.s3dis_augment if augment_pairs else None
            data = augment.make_siamese_batch(data, self.np_rng, aug)
            mask = augment.interleave_duplicate(mask)
            seg = augment.interleave_duplicate(b.seg)
            valid = augment.interleave_duplicate(valid)
        else:
            seg = b.seg
        return {
            "data": data.astype(np.float32),
            "seg": seg.astype(np.int32),
            "seg_onehot": onehot_encode(seg, self.num_classes),
            "mask": mask,
            "valid": valid,
        }

    def train_epoch(self, epoch: Optional[int] = None) -> Dict[str, float]:
        epoch = self.epoch if epoch is None else epoch
        siamese = self.style == "Full"
        gate = self._gate(epoch)
        augment_pairs = siamese and epoch >= self.rampup
        batches = self.ds.batches(self.train_idx, self.cfg.train.batch_size,
                                  shuffle=True, drop_last=True, rng=self.np_rng)
        return self._run_train_epoch(batches, epoch, gate, siamese, augment_pairs)

    def evaluate(self) -> Tuple[float, float, float, np.ndarray]:
        """Validation over the held-out area: global confusion mIoU
        (S3DIS_DGCNN_trainer.py:412-481). Returns (loss, acc, miou,
        per-class iou [13])."""
        acc = ConfusionAccumulator(self.num_classes)
        losses, loss_w = [], []
        for b in self.ds.batches(self.val_idx, self.cfg.train.batch_size):
            batch = self._assemble(b, siamese=False, augment_pairs=False,
                                   full_mask=True)
            prob, loss = self.eval_step(self.state, self._put(batch, pairs=False))
            prob = np.asarray(prob)[: b.valid]
            losses.append(float(loss))
            loss_w.append(b.valid)
            acc.update(prob.argmax(-1), b.seg[: b.valid])
        return (
            float(np.average(losses, weights=loss_w)) if losses else 0.0,
            acc.accuracy,
            acc.miou,
            acc.iou,
        )

    def test(self, rooms: s3dis_data.S3DISTestRooms, *,
             use_label_prop: Optional[bool] = None,
             pred_dir: Optional[str] = None,
             room_lp: bool = False) -> Dict[str, float]:
        """Room-by-room block inference + LP + optional per-room .mat dump
        (S3DIS_DGCNN_trainer.py:499-584).

        ``room_lp=True`` replaces the reference's per-block label
        propagation (S3DIS_DGCNN_trainer.py:539-556 — each 1m block is
        refined independently, so labels can disagree across block
        boundaries) with ONE matrix-free propagation over every block
        point of the room in global coordinates — a capability the
        reference's dense O(N^3) solver cannot reach at room scale.
        """
        if use_label_prop is None:
            use_label_prop = self.style == "Full"
        if room_lp and not use_label_prop:
            import warnings

            warnings.warn(
                "room_lp=True has no effect when use_label_prop is False "
                "(label propagation only runs for the Full style): falling "
                "back to plain per-block argmax", stacklevel=2)
        lp = self.cfg.labelprop
        conf = ConfusionAccumulator(self.num_classes)
        bs = max(self.cfg.train.batch_size, 1)
        eval_fwd = jax.jit(make_eval_logits_fn(self.cfg))
        for r in range(len(rooms)):
            blocks, labels, path, room_max = rooms.load_room(r, rng=self.np_rng)
            room_prob = []
            for start in range(0, len(blocks), bs):
                chunk = blocks[start : start + bs]
                valid = len(chunk)
                if valid < bs:  # pad to the compiled shape
                    pad = np.repeat(chunk[:1], bs - valid, axis=0)
                    chunk = np.concatenate([chunk, pad])
                logits = eval_fwd(self.state, chunk.astype(np.float32))
                prob = np.asarray(jax.nn.softmax(logits, axis=-1))[:valid]
                if use_label_prop and not room_lp:
                    prob = np.asarray(propagate_batch(
                        chunk[:valid, :, 0:3].astype(np.float32), prob,
                        chunk[:valid, :, 3:6].astype(np.float32),
                        alpha=lp.alpha, beta=lp.beta,
                        xyz_bandwidth=lp.xyz_bandwidth,
                        rgb_bandwidth=lp.rgb_bandwidth,
                        ridge=lp.ridge, solver=lp.solver,
                        cg_iters=lp.cg_iters, cg_tol=lp.cg_tol,
                    ))
                room_prob.append(prob)
            if room_prob:
                prob = np.concatenate(room_prob)
                if room_lp and use_label_prop and len(blocks):
                    pred = self.room_label_prop(blocks, prob, room_max)
                else:
                    pred = prob.argmax(-1)
                conf.update(pred, labels)
                if pred_dir is not None:
                    self._dump_room(pred_dir, path, blocks, pred, labels)
        return {
            "miou": conf.miou,
            "accuracy": conf.accuracy,
            "per_class_iou": conf.iou,
        }

    def room_label_prop(self, blocks: np.ndarray, prob: np.ndarray,
                        room_max: np.ndarray) -> np.ndarray:
        """One label propagation across ALL blocks of a room.

        Concatenates every block point into a single cloud in global room
        coordinates (block channels 6:9 x ``room_max``) and solves one
        matrix-free-CG propagation over it, so label mass flows across
        block boundaries. Blocks are padded to a multiple of 8 so rooms of
        similar size share one compiled CG program; pad points sit 2 m
        beyond the room extent on every axis, where exp(-1e3 d^2 >= 4e3)
        affinity underflows to exactly 0 — they neither receive nor donate
        label mass. The offset is deliberately SMALL: the matfree solver
        centers the feature cloud before its Gram (label_prop.py), so
        far-flung pads (the old 1 km placement) would drag the mean ~1e4
        feature units from the real points and the f32 cancellation error
        on d^2 would reach O(10) — enough to corrupt exp(-d^2) affinities
        (caught by test_room_lp_matches_dense_oracle at 0.86 argmax
        agreement vs the uncentered dense oracle).

        Args:
          blocks: [K, N, 9] room blocks (room_to_blocks layout).
          prob: [K, N, C] per-block softmax probabilities (pre-LP).
          room_max: [3] room extent in meters (load_room's scale).

        Returns:
          [K, N] refined integer predictions.
        """
        lp = self.cfg.labelprop
        k_blocks, n, c = prob.shape
        k_pad = -(-k_blocks // 8) * 8
        xyz = (blocks[:, :, 6:9] * room_max).astype(np.float32)
        rgb = blocks[:, :, 3:6].astype(np.float32)
        prob = prob.astype(np.float32)
        if k_pad > k_blocks:
            extra = k_pad - k_blocks
            pad_xyz = (np.asarray(room_max, np.float32) + 2.0).reshape(1, 1, 3)
            xyz = np.concatenate(
                [xyz, np.broadcast_to(pad_xyz, (extra, n, 3)).copy()])
            rgb = np.concatenate([rgb, np.zeros((extra, n, 3), np.float32)])
            prob = np.concatenate(
                [prob, np.full((extra, n, c), 1.0 / c, np.float32)])
        # the dense [N_room, N_room] Laplacian would be O(100k^2); only the
        # matrix-free and point-axis-sharded solvers scale to room level
        solver = "sharded" if lp.solver == "sharded" else "cg_matfree"
        y = propagate_batch(
            xyz.reshape(1, -1, 3), prob.reshape(1, -1, c),
            rgb.reshape(1, -1, 3),
            alpha=lp.alpha, beta=lp.beta, xyz_bandwidth=lp.xyz_bandwidth,
            rgb_bandwidth=lp.rgb_bandwidth, ridge=lp.ridge,
            solver=solver, cg_iters=lp.cg_iters, cg_tol=lp.cg_tol,
        )
        pred = np.asarray(y[0]).argmax(-1).reshape(k_pad, n)
        return pred[:k_blocks]

    @staticmethod
    def _dump_room(pred_dir: str, room_path: str, data, pred, gt) -> None:
        """Per-room {data, pred, gt} .mat export (S3DIS_DGCNN_trainer.py:573-580)."""
        import os
        import scipy.io as scio

        os.makedirs(pred_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(room_path))[0]
        scio.savemat(
            os.path.join(pred_dir, f"{name}_pred_gt.mat"),
            {"data": data, "pred": pred, "gt": gt},
        )
