"""Shared CLI plumbing: reference-compatible flags + config assembly.

The reference duplicates one argparse block across its four entry points
(train_ShapeNet.py:24-38, train_S3DIS.py:24-39, test_*.py); the flag names
and defaults here are kept drop-in identical (-er, -ep, -rp, -bs, -m, -sty,
-net, -ta, -dt), with additions: --DataPath (the reference hard-codes
./Dataset/<ds>), --num_devices (data-parallel mesh size), --seed. --GPU is
accepted for compatibility and ignored: cards are chosen with
CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
from typing import Optional

from weaksuppointcloudseg_tpu import configs


def base_parser(dataset: str, *, train: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Take parameters")
    p.add_argument("--GPU", "-gpu", type=int, default=0,
                   help="accepted for reference compatibility and ignored: "
                        "choose cards with CUDA_VISIBLE_DEVICES")
    p.add_argument("--m", "-m", type=float, default=0.1,
                   help="ratio of points labelled (0.01=1%%, 0.1=10%%, 1=100%%)")
    p.add_argument("--Network", "-net", type=str, default="DGCNN",
                   help="[options: DGCNN]")
    p.add_argument("--DataPath", type=str, default=None,
                   help=f"dataset root [default: ./Dataset/{dataset}]")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel mesh size (0 = single device)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--Precision", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="compute dtype for matmul-heavy ops (params / BN "
                        "stats / logits stay fp32). Default keeps the "
                        "preset's float32 reference-parity path")
    p.add_argument("--StaticGraph", action="store_true",
                   help="opt-in static-graph EdgeConv: ONE input-coordinate "
                        "kNN graph reused by every stage (NOT reference "
                        "parity — speed/accuracy trade, docs/kernels.md). "
                        "Test with the same flag the model trained with")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a jax.profiler device trace into DIR "
                        "(training: one post-compile epoch; view with "
                        "TensorBoard/xprof)")
    p.add_argument("--debug_nans", action="store_true",
                   help="run with jax_debug_nans: error out at the first "
                        "NaN-producing op (debug runs only — disables some "
                        "fusions and forces extra device syncs)")
    if train:
        p.add_argument("--batchsize", "-bs", type=int,
                       default=6 if dataset == "ShapeNet" else 3)
        p.add_argument("--ExpRslt", "-er", type=lambda s: s not in ("0", "False", ""),
                       default=False, help="export results/checkpoints")
        p.add_argument("--LearningRate", type=float, default=1e-3)
        p.add_argument("--Epoch", "-ep", type=int, default=201)
        p.add_argument("--Rampup", "-rp", type=int, default=101)
        p.add_argument("--Style", "-sty", type=str, default="Full",
                       help="[options: Plain, Full]")
        p.add_argument("--CompatFrozenGate", action="store_true",
                       help="reproduce the released code's frozen rampup gate "
                            "(quirk Q1): weak losses never receive gradient")
        p.add_argument("--Resume", type=str, default=None,
                       help="checkpoint path (or a Results datetime stamp) to "
                            "resume from — restores params, optimizer state, "
                            "BN stats, step AND epoch (complete resume; the "
                            "reference loses its epoch counter)")
    else:
        p.add_argument("--batchsize", type=int, default=1)
        p.add_argument("--Style", "-style", type=str, default="Full",
                       help="[options: Plain, Full]")
        p.add_argument("--Datetime", "-dt", type=str, default=None,
                       help="datetime stamp of the trained model to load")
        p.add_argument("--Checkpoint", type=str, default=None,
                       help="explicit checkpoint path (overrides --Datetime)")
        p.add_argument("--LPSolver", type=str, default=None,
                       choices=["solve", "cg", "cg_matfree", "sharded"],
                       help="label-propagation solver: factored-W CG "
                            "(default — Laplacian never materialized, "
                            "tol early exit, ~17x faster than LU at the "
                            "test shape), batched dense LU, matrix-free "
                            "CG (no NxN ever built), or point-axis-"
                            "sharded CG over the device mesh")
    return p


def debug_context(args):
    """NaN-checking context for a whole CLI run (--debug_nans)."""
    import contextlib

    if getattr(args, "debug_nans", False):
        from weaksuppointcloudseg_tpu.utils.profiling import nan_debug

        return nan_debug(True)
    return contextlib.nullcontext()


def profile_context(args):
    """Trace context for a whole inference/test run (--profile DIR)."""
    import contextlib

    if not getattr(args, "profile", None):
        return contextlib.nullcontext()
    from weaksuppointcloudseg_tpu.utils.profiling import trace

    return trace(args.profile)


def profile_epoch_context(args, epoch: int, start_epoch: int, last_epoch: int):
    """Trace context for one training epoch (--profile DIR).

    Traces the epoch after the first trained one, so compilation is
    excluded (falls back to the first if the run is a single epoch).
    """
    import contextlib

    if not getattr(args, "profile", None):
        return contextlib.nullcontext()
    target = start_epoch + 1 if start_epoch + 1 <= last_epoch else start_epoch
    if epoch != target:
        return contextlib.nullcontext()
    from weaksuppointcloudseg_tpu.utils.profiling import trace

    return trace(args.profile)


def build_config(args, dataset: str) -> configs.ExperimentConfig:
    make = configs.shapenet_config if dataset == "ShapeNet" else configs.s3dis_config
    cfg = make()
    train = dataclasses.replace(
        cfg.train,
        batch_size=getattr(args, "batchsize", cfg.train.batch_size),
        epochs=getattr(args, "Epoch", cfg.train.epochs),
        rampup=getattr(args, "Rampup", cfg.train.rampup),
        style=args.Style,
        label_fraction=args.m,
        seed=args.seed,
        num_devices=max(args.num_devices, 1),
    )
    schedule = dataclasses.replace(
        cfg.schedule,
        base_learning_rate=getattr(args, "LearningRate", cfg.schedule.base_learning_rate),
    )
    weaksup = dataclasses.replace(
        cfg.weaksup,
        rampup=getattr(args, "Rampup", cfg.weaksup.rampup),
        compat_frozen_gate=getattr(args, "CompatFrozenGate", False),
    )
    labelprop = cfg.labelprop
    if getattr(args, "LPSolver", None):
        labelprop = dataclasses.replace(labelprop, solver=args.LPSolver)
    model = cfg.model
    if getattr(args, "Precision", None):
        model = dataclasses.replace(model, compute_dtype=args.Precision)
    if getattr(args, "StaticGraph", False):
        model = dataclasses.replace(model, static_graph=True)
    return dataclasses.replace(cfg, model=model, train=train,
                               schedule=schedule, weaksup=weaksup,
                               labelprop=labelprop)


def result_base_path(dataset: str, args) -> str:
    """Results/<ds>/<Net>_sty-<Style>_m-<m>_<datetime> (train_ShapeNet.py:59-62)."""
    dt = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    return os.path.expanduser(
        f"./Results/{dataset}/{args.Network}_sty-{args.Style}_m-{args.m}_{dt}"
    )


def find_result_dir(dataset: str, args) -> str:
    """Locate a train run's result dir by its -dt datetime stamp."""
    root = os.path.expanduser(f"./Results/{dataset}")
    if args.Datetime is None:
        raise SystemExit("need --Datetime (or --Checkpoint) to locate the model")
    matches = [d for d in os.listdir(root) if d.endswith(args.Datetime)]
    if len(matches) != 1:
        raise SystemExit(f"{len(matches)} result dirs match '{args.Datetime}' in {root}")
    return os.path.join(root, matches[0])


def resolve_resume_checkpoint(dataset: str, resume: str) -> str:
    """--Resume accepts an explicit checkpoint path or a datetime stamp."""
    if os.path.exists(resume) or resume.endswith(".npz"):
        return resume
    root = os.path.expanduser(f"./Results/{dataset}")
    matches = [d for d in os.listdir(root) if d.endswith(resume)]
    if len(matches) != 1:
        raise SystemExit(f"{len(matches)} result dirs match '{resume}' in {root}")
    return os.path.join(root, matches[0], "Checkpoint", "Checkpoint_epoch-best.npz")
