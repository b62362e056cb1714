"""S3DIS room-wise inference CLI (reference: test_S3DIS.py).

Per-room block inference + label propagation + per-category IoU print +
per-room .mat prediction dumps. (The reference crashes after printing IoU on
an undefined RSLT_PATH — quirk Q5 — and its room-list path join discards the
base dir — quirk Q6; both fixed.)
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as scio

from weaksuppointcloudseg_tpu.cli import common
from weaksuppointcloudseg_tpu.data import s3dis as s3dis_data
from weaksuppointcloudseg_tpu.train.loop import S3DISTrainer
from weaksuppointcloudseg_tpu.utils.compile_cache import init_compile_cache

S3DIS_CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board",  # + clutter
    "clutter",
]


def main(argv=None) -> dict:
    p = common.base_parser("S3DIS", train=False)
    p.add_argument("--test_area", "-ta", type=int, default=5)
    p.add_argument("--RoomsPath", type=str, default=None,
                   help="base dir holding meta/<area>_data_label.txt and the "
                        "raw room files [default: --DataPath or ./Dataset/S3DIS]")
    p.add_argument("--RoomLP", action="store_true",
                   help="one matrix-free label propagation over ALL block "
                        "points of each room in global coordinates (label "
                        "consistency across block boundaries) instead of "
                        "the reference's independent per-block refinement. "
                        "Requires -sty Full (label propagation only runs "
                        "for the Full style); ignored with a warning "
                        "otherwise")
    args = p.parse_args(argv)
    init_compile_cache()
    args.Epoch = 1
    cfg = common.build_config(args, "S3DIS")
    data_path = args.DataPath or "./Dataset/S3DIS/indoor3d_sem_seg_hdf5_data"
    rooms_base = args.RoomsPath or args.DataPath or "./Dataset/S3DIS"

    ds = s3dis_data.S3DISDataset(data_path)
    rooms = s3dis_data.S3DISTestRooms(
        rooms_base, f"area{args.test_area}", num_point=cfg.model.num_points
    )
    trainer = S3DISTrainer(cfg, ds, None, test_area=args.test_area, seed=args.seed)

    if args.Checkpoint:
        ckpt = args.Checkpoint
        base = os.path.dirname(os.path.dirname(ckpt))
    else:
        base = common.find_result_dir("S3DIS", args)
        ckpt = os.path.join(base, "Checkpoint", "Checkpoint_epoch-best.npz")
    trainer.restore_checkpoint(ckpt)

    pred_dir = os.path.join(base, "Prediction") if base else None
    with common.debug_context(args), common.profile_context(args):
        res = trainer.test(
            rooms, use_label_prop=args.Style == "Full", pred_dir=pred_dir,
            room_lp=args.RoomLP,
        )
    print(f"Test Area {args.test_area}  mIoU {100 * res['miou']:.2f}%  "
          f"acc {100 * res['accuracy']:.2f}%")
    for name, iou in zip(S3DIS_CLASSES, res["per_class_iou"]):
        print(f"  {name:10s} IoU {100 * iou:.2f}%")
    if pred_dir:
        scio.savemat(
            os.path.join(pred_dir, "PerClassIoU.mat"),
            {"per_class_iou": np.asarray(res["per_class_iou"])},
        )
    return res


if __name__ == "__main__":
    main()
