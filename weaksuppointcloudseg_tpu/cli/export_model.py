"""Export a trained checkpoint as a portable serving artifact.

    python -m weaksuppointcloudseg_tpu.cli.export_model ShapeNet \
        --Checkpoint <ckpt.npz> --Output model.stablehlo \
        --batchsize 8 --num_points 3000

The output is a self-contained StableHLO function (weights embedded,
population-BN eval mode) loadable with
``weaksuppointcloudseg_tpu.utils.export.load_inference`` — or any
matching-version JAX process via ``jax.export.deserialize`` — on the
platforms it was exported for. No analog exists in the reference (its
deployment story is re-running test_*.py against a TF1 checkpoint).
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=["ShapeNet", "S3DIS"])
    p.add_argument("--Checkpoint", required=True,
                   help="checkpoint .npz to freeze")
    p.add_argument("--Output", required=True, help="artifact path")
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--num_points", type=int, default=None,
                   help="serving point count (default: model preset)")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--num_categories", type=int, default=None)
    p.add_argument("--platforms", type=str, default="cpu,cuda")
    args = p.parse_args(argv)

    from weaksuppointcloudseg_tpu.utils.compile_cache import (
        init_compile_cache,
    )

    init_compile_cache()

    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.utils.checkpoint import restore_checkpoint
    from weaksuppointcloudseg_tpu.utils.export import export_inference

    make = (configs.shapenet_config if args.dataset == "ShapeNet"
            else configs.s3dis_config)
    cfg = make()
    overrides = {}
    if args.num_classes:
        overrides["num_classes"] = args.num_classes
    if args.num_categories is not None:
        overrides["num_categories"] = args.num_categories
    if overrides:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **overrides))

    import jax
    import numpy as np

    state = create_train_state(jax.random.PRNGKey(0), cfg)
    tree = restore_checkpoint(args.Checkpoint, {
        "params": state.params, "bn_state": state.bn_state,
        "opt_state": state.opt_state, "step": state.step,
        "epoch": np.asarray(0),
    })
    out = export_inference(
        cfg, tree["params"], tree["bn_state"], args.Output,
        batch_size=args.batchsize, num_points=args.num_points,
        platforms=tuple(args.platforms.split(",")),
    )
    print(f"exported {args.dataset} inference to {out} "
          f"(platforms: {args.platforms})")


if __name__ == "__main__":
    main()
