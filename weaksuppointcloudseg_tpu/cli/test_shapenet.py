"""ShapeNet held-out evaluation CLI (reference: test_ShapeNet.py).

Restores a checkpoint and runs 3000-point resampled inference with
probabilistic label propagation for the Full style (both styles work here —
quirk Q4, the reference's Plain-style crash, is fixed by gating LP on style).
"""

from __future__ import annotations

import os

from weaksuppointcloudseg_tpu.cli import common
from weaksuppointcloudseg_tpu.data import shapenet as shapenet_data
from weaksuppointcloudseg_tpu.train.loop import ShapeNetTrainer
from weaksuppointcloudseg_tpu.utils.compile_cache import init_compile_cache


def main(argv=None) -> dict:
    p = common.base_parser("ShapeNet", train=False)
    p.add_argument("--num_points", type=int, default=3000,
                   help="fixed resample size at test time "
                        "(ShapeNet_DGCNN_trainer.py:530-535)")
    args = p.parse_args(argv)
    init_compile_cache()
    args.Epoch = 1
    cfg = common.build_config(args, "ShapeNet")
    data_path = args.DataPath or "./Dataset/ShapeNet"

    ds = shapenet_data.ShapeNetDataset(data_path)
    testset = shapenet_data.ShapeNetTestSet(data_path)
    import dataclasses

    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model,
            num_classes=ds.meta.num_part_cats,
            num_categories=ds.meta.num_categories,
        ),
    )
    trainer = ShapeNetTrainer(cfg, ds, None, seed=args.seed)

    if args.Checkpoint:
        ckpt = args.Checkpoint
    else:
        base = common.find_result_dir("ShapeNet", args)
        ckpt = os.path.join(base, "Checkpoint", "Checkpoint_epoch-best.npz")
    trainer.restore_checkpoint(ckpt)

    with common.debug_context(args), common.profile_context(args):
        res = trainer.test(
            testset,
            use_label_prop=args.Style == "Full",
            num_points=args.num_points,
        )
    print(
        f"Test perdata mIoU {100 * res['perdata_miou']:.2f}%  "
        f"pershape mIoU {100 * res['pershape_miou']:.2f}%  "
        f"acc {100 * res['accuracy']:.2f}%"
    )
    import numpy as np

    for name, iou in zip(ds.meta.objnames, res["per_category_iou"]):
        if not np.isnan(iou):
            print(f"  {name:12s} IoU {100 * iou:.2f}%")
    return res


if __name__ == "__main__":
    main()
