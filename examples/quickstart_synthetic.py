"""Runnable end-to-end quickstart on synthetic data (no downloads).

Generates a miniature ShapeNet-format dataset, trains the Full-style
weak-supervision pipeline for a few epochs, evaluates, and runs test-time
inference with probabilistic label propagation.

    python examples/quickstart_synthetic.py [--epochs 8]

Runs on JAX's default backend (a GPU if one is present); on a CPU-only
machine set ``JAX_PLATFORMS=cpu`` (~2 min).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--points", type=int, default=64)
    args = p.parse_args()

    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.data import sampling, shapenet
    from weaksuppointcloudseg_tpu.train.loop import ShapeNetTrainer

    workdir = tempfile.mkdtemp(prefix="wspcs_quickstart_")
    shapenet.write_synthetic(
        workdir, num_points=args.points,
        train_samples=32, val_samples=8, test_samples=4,
    )
    print(f"synthetic ShapeNet written to {workdir}")

    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, num_points=args.points, num_classes=12,
            num_categories=4, k=8,
            edge_channels=((16, 16), (16, 16), (16,)),
            global_channels=64, head_channels=(32, 32, 16),
            head_keep_prob=(0.6, 0.6, None),
        ),
        train=dataclasses.replace(
            cfg.train, batch_size=4, style="Full", rampup=3),
        weaksup=dataclasses.replace(cfg.weaksup, smooth_knn=4, rampup=3),
    )

    ds = shapenet.ShapeNetDataset(workdir)
    pts_idx = sampling.generate_sample_index(
        ds.num_samples("train"), args.points, m=0.1)
    trainer = ShapeNetTrainer(cfg, ds, pts_idx, seed=0)

    for epoch in range(args.epochs):
        m = trainer.train_epoch(epoch)
        gate = "on" if epoch >= cfg.train.rampup else "off"
        print(f"epoch {epoch}: total={m['total']:.3f} seg={m['seg']:.3f} "
              f"acc={100 * m['acc']:.1f}% (weak losses {gate})")

    loss, acc, perdata, _ = trainer.evaluate()
    print(f"val: loss={loss:.3f} acc={100 * acc:.1f}% "
          f"perdata mIoU={100 * perdata:.1f}%")

    res = trainer.test(shapenet.ShapeNetTestSet(workdir),
                       num_points=args.points + args.points // 2,
                       use_label_prop=True)
    print(f"test (+label propagation): perdata mIoU="
          f"{100 * res['perdata_miou']:.1f}% acc={100 * res['accuracy']:.1f}%")

    # serving: freeze the trained forward into a portable StableHLO artifact
    from weaksuppointcloudseg_tpu.utils.export import (
        export_inference, load_inference)

    artifact = os.path.join(workdir, "model.stablehlo")
    # default platforms ("cpu", "cuda"): the round-trip below runs on
    # whichever of the two this process uses
    export_inference(cfg, trainer.state.params, trainer.state.bn_state,
                     artifact, batch_size=2)
    serve, meta = load_inference(artifact)
    x = np.asarray(ds.batches("val", 2).__next__().data[:2], np.float32)
    cat = np.zeros((2, cfg.model.num_categories), np.float32)
    cat[:, 0] = 1.0
    prob = np.asarray(serve(x, cat))
    print(f"serving export: {meta['num_points']}-pt artifact, prob shape "
          f"{prob.shape}, rows sum to {prob.sum(-1).mean():.3f}")


if __name__ == "__main__":
    main()
