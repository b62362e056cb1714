"""ShapeNet weak-sup training CLI (reference: train_ShapeNet.py).

Usage parity with the reference's flagship command (train_script:1-2):

    python -m weaksuppointcloudseg_tpu.cli.train_shapenet \
        -m 0.1 -sty Full -bs 32 --Epoch 201 --ExpRslt 1
"""

from __future__ import annotations

import os

import numpy as np

from weaksuppointcloudseg_tpu.cli import common
from weaksuppointcloudseg_tpu.data import sampling
from weaksuppointcloudseg_tpu.data import shapenet as shapenet_data
from weaksuppointcloudseg_tpu.train.loop import ShapeNetTrainer
from weaksuppointcloudseg_tpu.utils.compile_cache import init_compile_cache
from weaksuppointcloudseg_tpu.utils.tools import Summary


def main(argv=None) -> None:
    args = common.base_parser("ShapeNet", train=True).parse_args(argv)
    init_compile_cache()
    cfg = common.build_config(args, "ShapeNet")
    data_path = args.DataPath or "./Dataset/ShapeNet"

    ds = shapenet_data.ShapeNetDataset(data_path)
    num_train = ds.num_samples("train")
    num_points = ds.split("train")[0].shape[1]  # 2048 for real ShapeNet
    # derive class/category counts from the dataset meta (16/50 for real
    # ShapeNet; keeps synthetic/tiny datasets exact)
    import dataclasses

    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model,
            num_classes=ds.meta.num_part_cats,
            num_categories=ds.meta.num_categories,
        ),
    )

    # SampIndex: reference .mat if present, seeded generator otherwise
    # (train_ShapeNet.py:90-96; .MISSING_LARGE_BLOBS note in SURVEY.md C19)
    pts_idx = None
    if args.m < 1.0:
        pts_idx = sampling.load_or_generate(
            os.path.join(data_path, "Preprocess"), args.m,
            num_samples=num_train, num_points=num_points,
            seed=args.seed,
        )

    base_path = common.result_base_path("ShapeNet", args) if args.ExpRslt else None
    summary = Summary(base_path, enabled=args.ExpRslt)
    summary.log(f"{vars(args)}\n")

    trainer = ShapeNetTrainer(
        cfg, ds, pts_idx, seed=args.seed,
        ckpt_dir=summary.ckpt_dir,
        num_devices=args.num_devices or None,
    )
    if args.Resume:
        trainer.restore_checkpoint(
            common.resolve_resume_checkpoint("ShapeNet", args.Resume))
        summary.log(f"Resumed from epoch {trainer.epoch}, "
                    f"step {int(trainer.state.step)}\n")

    from weaksuppointcloudseg_tpu.utils.profiling import MetricsLogger, StepTimer

    metrics_log = MetricsLogger(
        os.path.join(summary.summary_dir, "metrics.jsonl")
        if summary.enabled else None)
    timer = StepTimer()
    epoch_points = (
        (num_train // cfg.train.batch_size) * cfg.train.batch_size * num_points)

    best_miou = -1.0
    start_epoch = trainer.epoch
    with common.debug_context(args):
        for epoch in range(start_epoch, args.Epoch):
            timer.start()
            with common.profile_epoch_context(args, epoch, start_epoch,
                                              args.Epoch - 1):
                m = trainer.train_epoch(epoch)
            epoch_s = timer.stop(points=epoch_points)
            summary.log(
                f"Epoch {epoch} Train loss {m['total']:.4f} acc {100 * m['acc']:.2f}% "
                f"lr {m['lr']:.2e} ({epoch_points / epoch_s:,.0f} pts/s)\n"
            )
            metrics_log.log("train_epoch", epoch=epoch,
                            points_per_sec=epoch_points / epoch_s, **m)
            if epoch % 5 == 0:  # eval cadence: train_ShapeNet.py:121
                loss, acc, perdata, pershape = trainer.evaluate()
                miou = float(np.mean(pershape))
                summary.log(
                    f"Epoch {epoch} Eval loss {loss:.4f} acc {100 * acc:.2f}% "
                    f"perdata mIoU {100 * perdata:.2f}% pershape mIoU {100 * miou:.2f}%\n"
                )
                metrics_log.log("eval", epoch=epoch, loss=loss, acc=acc,
                                perdata_miou=perdata, pershape_miou=miou)
                if args.ExpRslt:
                    trainer.save_checkpoint(metric=miou)
                if miou > best_miou:
                    best_miou = miou
                    summary.log(f"Epoch {epoch} new best pershape mIoU {100 * miou:.2f}%\n")


if __name__ == "__main__":
    main()
