"""Accuracy-vs-iterations evidence for the label-propagation defaults.

Production configs run ``cg_iters=50`` while the equivalence tests use
200 iterations; this shows the shipped setting preserves LP's accuracy
EFFECT (not just its fixed point). It is the committed evidence behind
``configs.LabelPropConfig(solver="cg", cg_iters=50, cg_tol=1e-5)``:

- builds a synthetic scene where LP demonstrably helps: tight surface
  clusters (one class each, within-cluster spacing ~0.02 so the
  exp(-1e3 d^2) affinity actually couples neighbors — the geometry regime
  of pc_normalize'd ShapeNet surfaces) with a fraction of points given
  corrupted low-confidence predictions;
- sweeps the factored-W CG solver over fixed iteration counts plus the
  production config (cap 50, rel-tol 1e-5 early exit), against the dense
  LU oracle (the reference's explicit-inverse semantics,
  ProbLabelPropagation.py:21-23);
- reports mIoU before LP, after LP per setting, and argmax agreement with
  the LU solution.

Run from the repository root (on a GPU, or on the CPU with
``JAX_PLATFORMS=cpu``):

    PYTHONPATH=. python scripts/lp_iters_curve.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)


def make_scene(rng, n_clusters=20, pts_per=150, k_classes=50,
               corrupt_frac=0.3):
    """Clustered unit-sphere scene + corrupted predictions.

    Returns (xyz [N,3] float32, labels [N] int, probs [N,K] float32).
    ``corrupt_frac`` of the points get a near-uniform prediction tilted
    toward a WRONG class — the failure mode LP exists to repair
    (low-entropy neighbors outvote high-entropy mistakes).
    """
    n = n_clusters * pts_per
    centers = rng.standard_normal((n_clusters, 3))
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)  # on sphere
    xyz = np.repeat(centers, pts_per, 0) + rng.standard_normal(
        (n, 3)).astype(np.float64) * 0.02
    xyz = (xyz / np.abs(xyz).max()).astype(np.float32)  # ~pc_normalize
    labels = np.repeat(rng.choice(k_classes, n_clusters, replace=False),
                       pts_per)

    probs = np.full((n, k_classes), 1e-3, np.float32)
    probs[np.arange(n), labels] = 1.0
    corrupt = rng.uniform(size=n) < corrupt_frac
    wrong = (labels + 1 + rng.integers(0, k_classes - 1, n)) % k_classes
    probs[corrupt] = 1.0 / k_classes
    probs[corrupt, wrong[corrupt]] += 0.05  # mild wrong-class tilt
    probs /= probs.sum(-1, keepdims=True)
    return xyz, labels, probs


def miou(pred, labels, k_classes):
    ious = []
    for c in np.unique(labels):
        inter = ((pred == c) & (labels == c)).sum()
        union = ((pred == c) | (labels == c)).sum()
        ious.append(inter / union if union else 1.0)
    return float(np.mean(ious))


def main():
    import jax.numpy as jnp  # noqa: F401  (backend init)

    from weaksuppointcloudseg_tpu.configs import LabelPropConfig
    from weaksuppointcloudseg_tpu.propagate.label_prop import propagate_batch

    lp = LabelPropConfig()
    k_classes = 50
    rows = []
    agree_rows = []
    for seed in range(5):
        rng = np.random.default_rng(seed)
        xyz, labels, probs = make_scene(rng, k_classes=k_classes)
        x = xyz[None]
        g = probs[None]
        base = miou(probs.argmax(-1), labels, k_classes)
        lu = np.asarray(propagate_batch(x, g, solver="solve"))[0]
        lu_pred = lu.argmax(-1)
        row = {"seed": seed, "no_lp": base,
               "lu": miou(lu_pred, labels, k_classes)}
        agree = {"seed": seed}
        for iters in (2, 4, 8, 12, 50):
            # tol=0 => exactly `iters` iterations (no early exit) for the
            # fixed points of the curve; the production entry re-enables
            # the shipped tol so it measures the REAL default behavior.
            tol = lp.cg_tol if iters == 50 else 0.0
            y = np.asarray(propagate_batch(
                x, g, solver="cg", cg_iters=iters, cg_tol=tol))[0]
            name = f"cg{iters}" + ("(prod)" if iters == 50 else "")
            row[name] = miou(y.argmax(-1), labels, k_classes)
            agree[name] = float((y.argmax(-1) == lu_pred).mean())
        rows.append(row)
        agree_rows.append(agree)

    keys = [k for k in rows[0] if k != "seed"]
    print("mIoU (synthetic clustered scene, 30% corrupted predictions):")
    print("seed  " + "  ".join(f"{k:>10s}" for k in keys))
    for r in rows:
        print(f"{r['seed']:4d}  " + "  ".join(f"{r[k]:10.4f}" for k in keys))
    mean = {k: float(np.mean([r[k] for r in rows])) for k in keys}
    print("mean  " + "  ".join(f"{mean[k]:10.4f}" for k in keys))
    print("\nargmax agreement with dense LU:")
    akeys = [k for k in agree_rows[0] if k != "seed"]
    amean = {k: float(np.mean([r[k] for r in agree_rows])) for k in akeys}
    print("mean  " + "  ".join(f"{k}={amean[k]:.4f}" for k in akeys))


if __name__ == "__main__":
    main()
