"""S3DIS weak-sup training CLI (reference: train_S3DIS.py).

Usage parity with the reference's flagship command (train_script:4-5):

    python -m weaksuppointcloudseg_tpu.cli.train_s3dis \
        -m 0.1 -sty Full -bs 14 --Epoch 201 -ta 5 --ExpRslt 1

m=0 selects the "1 labelled point per class per block" scheme
(train_S3DIS.py:96-99).
"""

from __future__ import annotations

import os

import numpy as np

from weaksuppointcloudseg_tpu.cli import common
from weaksuppointcloudseg_tpu.data import sampling
from weaksuppointcloudseg_tpu.data import s3dis as s3dis_data
from weaksuppointcloudseg_tpu.train.loop import S3DISTrainer
from weaksuppointcloudseg_tpu.utils.compile_cache import init_compile_cache
from weaksuppointcloudseg_tpu.utils.tools import Summary


def main(argv=None) -> None:
    p = common.base_parser("S3DIS", train=True)
    p.add_argument("--test_area", "-ta", type=int, default=5,
                   help="Test area 1 to 6")
    args = p.parse_args(argv)
    init_compile_cache()
    cfg = common.build_config(args, "S3DIS")
    data_path = args.DataPath or "./Dataset/S3DIS/indoor3d_sem_seg_hdf5_data"

    ds = s3dis_data.S3DISDataset(data_path)

    pts_idx = None
    if args.m < 1.0:
        pts_idx = sampling.load_or_generate(
            os.path.join(os.path.dirname(data_path.rstrip("/")), "Preprocess"),
            args.m,
            num_samples=len(ds.room_filelist),
            num_points=ds.data.shape[1],  # 4096 for real S3DIS
            seg_labels=ds.label if args.m == 0 else None,
            seed=args.seed,
        )

    base_path = common.result_base_path("S3DIS", args) if args.ExpRslt else None
    summary = Summary(base_path, enabled=args.ExpRslt)
    summary.log(f"{vars(args)}\n")

    trainer = S3DISTrainer(
        cfg, ds, pts_idx, test_area=args.test_area, seed=args.seed,
        ckpt_dir=summary.ckpt_dir,
        num_devices=args.num_devices or None,
    )
    if args.Resume:
        trainer.restore_checkpoint(
            common.resolve_resume_checkpoint("S3DIS", args.Resume))
        summary.log(f"Resumed from epoch {trainer.epoch}, "
                    f"step {int(trainer.state.step)}\n")

    from weaksuppointcloudseg_tpu.utils.profiling import MetricsLogger, StepTimer

    metrics_log = MetricsLogger(
        os.path.join(summary.summary_dir, "metrics.jsonl")
        if summary.enabled else None)
    timer = StepTimer()
    n_points = ds.data.shape[1]
    epoch_points = (
        (len(trainer.train_idx) // cfg.train.batch_size)
        * cfg.train.batch_size * n_points)

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
            if epoch % 5 == 0:
                loss, acc, miou, per_class = trainer.evaluate()
                summary.log(
                    f"Epoch {epoch} Eval loss {loss:.4f} acc {100 * acc:.2f}% "
                    f"mIoU {100 * miou:.2f}%\n"
                )
                metrics_log.log("eval", epoch=epoch, loss=loss, acc=acc, miou=miou)
                if args.ExpRslt:
                    trainer.save_checkpoint(metric=miou)
                if miou > best_miou:
                    best_miou = miou
                    summary.log(f"Epoch {epoch} new best mIoU {100 * miou:.2f}%\n")


if __name__ == "__main__":
    main()
