"""Room-level vs per-block label propagation: the accuracy case for --RoomLP.

RoomLP's tests prove correctness (CG == dense oracle, pad innocuity) but
not BENEFIT. This script constructs the exact failure
mode per-block LP (the reference's semantics,
S3DIS_DGCNN_trainer.py:539-556: each 1 m block refined independently) is
blind to — objects STRADDLING block boundaries whose confident predictions
all sit on one side — and measures mIoU for:

  none   : plain argmax of the (partially corrupted) predictions
  block  : per-block LP — what the reference does; the corrupted half of a
           straddling object has no confident same-label support inside
           its own block, so LP cannot repair it (and often overwrites it
           with the block's background labels)
  room   : ONE matrix-free LP over every point of the room in global
           coordinates (the --RoomLP path): label mass flows across the
           boundary from the confident half.

Scene: 4 one-meter blocks in a row; per block 2 interior background
clusters (confident, correct); 3 dense objects centered exactly ON the
block boundaries (x = 1, 2, 3 m; sigma 4 cm, so within the exp(-1e3 d^2)
affinity radius of ~12 cm); each object's points on the right of its
boundary get near-uniform corrupted predictions. Each cluster carries its
own RGB color (both modes see it).

    PYTHONPATH=/root/repo python scripts/roomlp_ab.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

N_BLOCKS = 4
K_CLS = 13


def make_room(rng, pts_per_cluster=48, bg_clusters=2, corrupt_conf=None):
    """Returns xyz [N,3] (global meters), rgb [N,3], labels [N], probs [N,K]."""
    xs, rgbs, labels, conf = [], [], [], []
    label_iter = iter(rng.permutation(K_CLS))

    def add_cluster(center, label, n, confident_mask):
        pts = center + rng.standard_normal((n, 3)) * 0.04
        pts[:, 2] = np.abs(pts[:, 2]) * 0.5  # thin z
        xs.append(pts)
        rgbs.append(np.tile(rng.uniform(0, 1, (1, 3)), (n, 1)))
        labels.append(np.full(n, label))
        conf.append(confident_mask)

    # interior background clusters: fully confident
    for b in range(N_BLOCKS):
        for _ in range(bg_clusters):
            c = np.array([b + rng.uniform(0.25, 0.75),
                          rng.uniform(0.25, 0.75), 0.0])
            add_cluster(c, int(next(label_iter)), pts_per_cluster,
                        np.ones(pts_per_cluster, bool))

    # boundary objects: points right of the boundary are corrupted
    for bx in range(1, N_BLOCKS):
        c = np.array([float(bx), rng.uniform(0.3, 0.7), 0.0])
        n = pts_per_cluster * 2
        pts = c + rng.standard_normal((n, 3)) * 0.04
        pts[:, 2] = np.abs(pts[:, 2]) * 0.5
        xs.append(pts)
        rgbs.append(np.tile(rng.uniform(0, 1, (1, 3)), (n, 1)))
        lab = int(next(label_iter))
        labels.append(np.full(n, lab))
        conf.append(pts[:, 0] < bx)  # left side confident, right corrupted

    xyz = np.concatenate(xs).astype(np.float32)
    rgb = np.concatenate(rgbs).astype(np.float32)
    labels = np.concatenate(labels).astype(np.int64)
    conf = np.concatenate(conf)

    probs = np.full((len(labels), K_CLS), 1e-3, np.float32)
    probs[np.arange(len(labels)), labels] = 1.0
    wrong = (labels + 1 + rng.integers(0, K_CLS - 1, len(labels))) % K_CLS
    probs[~conf] = 1.0 / K_CLS
    probs[~conf, wrong[~conf]] += 0.05
    probs /= probs.sum(-1, keepdims=True)
    return xyz, rgb, labels, probs


def miou(pred, labels):
    ious = []
    for c in np.unique(labels):
        inter = ((pred == c) & (labels == c)).sum()
        union = ((pred == c) | (labels == c)).sum()
        ious.append(inter / union if union else 1.0)
    return float(np.mean(ious))


def run_modes(xyz, rgb, labels, probs):
    """Returns {mode: mIoU} for none / block / room."""
    from weaksuppointcloudseg_tpu.propagate.label_prop import propagate_batch

    out = {"none": miou(probs.argmax(-1), labels)}

    # per-block LP (reference semantics): block-local coordinates — LP
    # distance is translation-invariant, so raw coords work directly
    pred_blk = np.empty(len(labels), np.int64)
    block_of = np.clip(xyz[:, 0].astype(int), 0, N_BLOCKS - 1)
    for b in range(N_BLOCKS):
        sel = block_of == b
        y = np.asarray(propagate_batch(
            xyz[None, sel], probs[None, sel], rgb[None, sel],
            solver="cg"))[0]
        pred_blk[sel] = y.argmax(-1)
    out["block"] = miou(pred_blk, labels)

    # room LP: one matrix-free solve over the whole room
    y = np.asarray(propagate_batch(
        xyz[None], probs[None], rgb[None], solver="cg_matfree"))[0]
    out["room"] = miou(y.argmax(-1), labels)
    return out


def main():
    rows = []
    for seed in range(5):
        rng = np.random.default_rng(seed)
        rows.append(run_modes(*make_room(rng)))
        print(f"seed {seed}: " + "  ".join(
            f"{k}={v:.4f}" for k, v in rows[-1].items()))
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print("mean  : " + "  ".join(f"{k}={v:.4f}" for k, v in mean.items()))
    assert mean["room"] > mean["block"], "RoomLP should beat per-block LP"


if __name__ == "__main__":
    main()
