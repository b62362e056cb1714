"""Dataclass configs collecting every hyperparameter the reference hard-codes.

The reference scatters its hyperparameters across trainers and model files
(LR/BN schedules: ShapeNet/ShapeNet_DGCNN_trainer.py:25-54; k=20:
ShapeNet/DGCNN_ShapeNet.py:21; smooth gamma=0.1, knn=10:
Util/SmoothConstraint.py:130; LP alpha=beta=1, K=10:
ShapeNet/ShapeNet_DGCNN_trainer.py:136-138; S3DIS siamese x10:
S3DIS/S3DIS_DGCNN_trainer.py:128). Here they are all named fields with
per-dataset presets, so CLIs stay drop-in compatible with the reference flags
(-m, -sty, -rp, -bs, -ta, -er) while everything is overridable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """LR + batch-norm momentum schedules.

    Mirrors ShapeNet/ShapeNet_DGCNN_trainer.py:25-54 (identical in the S3DIS
    trainer): staircase exponential decay driven by `step * batch_size`
    (number of samples seen).
    """

    base_learning_rate: float = 1e-3
    lr_decay_step: int = 16881 * 20  # samples, not steps
    lr_decay_rate: float = 0.5
    lr_floor: float = 1e-5
    bn_init_decay: float = 0.5
    bn_decay_decay_rate: float = 0.5
    bn_decay_decay_step: int = 16881 * 20 * 2  # samples
    bn_decay_clip: float = 0.99


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DGCNN segmentation architecture knobs.

    ShapeNet variant: ShapeNet/DGCNN_ShapeNet.py:15-113 (k=20, transform net,
    category-label branch, seg head 256/256/128/num_classes, dropout keep 0.6).
    S3DIS variant: S3DIS/DGCNN_S3DIS.py:24-104 (9-channel input, kNN graph on
    channels 6:9, no transform net / category branch, head 512/256/num_classes,
    dropout keep 0.7).
    """

    num_points: int = 2048
    in_channels: int = 3
    num_classes: int = 50
    k: int = 20
    # channel range the kNN graph is built on (S3DIS uses normalized XYZ 6:9)
    knn_channels: Optional[Tuple[int, int]] = None
    use_transform_net: bool = True
    num_categories: int = 0  # >0 enables the one-hot category-label branch
    edge_channels: Tuple[Tuple[int, ...], ...] = ((64, 64), (64, 64), (64,))
    global_channels: int = 1024
    category_embed_channels: int = 64
    head_channels: Tuple[int, ...] = (256, 256, 128)
    # dropout keep-probability per head layer (None = no dropout after layer)
    head_keep_prob: Tuple[Optional[float], ...] = (0.6, 0.6, None)
    bn_eps: float = 1e-3
    # The S3DIS head convs don't receive the scheduled bn_decay in the
    # reference (DGCNN_S3DIS.py:95-101) and fall back to tf_util's fixed 0.9
    # (tf_util.py:523); None means the scheduled decay applies everywhere.
    head_bn_fixed_decay: Optional[float] = None
    # compute dtype for matmul-heavy ops (params & BN stats stay fp32)
    compute_dtype: str = "float32"
    # STATIC-graph EdgeConv (opt-in, NOT reference parity): the kNN graph
    # is built ONCE on the model's input coordinates (the transform
    # branch's graph on ShapeNet; the first stage's on S3DIS) and reused
    # by every later EdgeConv stage instead of recomputing kNN in feature
    # space per stage (the reference's dynamic graph, DGCNN_ShapeNet.py:
    # 30-66 / tf_util.py:638-706). Removes the kNN selection of every
    # reused stage — a speed/accuracy trade (docs/kernels.md).
    static_graph: bool = False


@dataclasses.dataclass(frozen=True)
class WeakSupConfig:
    """Weak-supervision loss settings (ShapeNet_DGCNN_trainer.py:115-133)."""

    siamese_weight: float = 1.0  # S3DIS uses 10.0 (S3DIS_DGCNN_trainer.py:128)
    smooth_gamma: float = 1e-1
    smooth_knn: int = 10
    # channel range fed to the smooth loss distance: ShapeNet passes xyz
    # (all 3), S3DIS passes xyzrgb cols 0:6 (S3DIS_DGCNN_trainer.py:137)
    smooth_channels: Optional[Tuple[int, int]] = None
    rampup: int = 101
    # True reproduces the released code where the rampup gate is a frozen
    # graph constant 0.0 (quirk Q1, ShapeNet_DGCNN_trainer.py:92-100): the
    # weak losses never receive gradient. False implements the paper's intent:
    # the gate turns on at epoch >= rampup.
    compat_frozen_gate: bool = False


@dataclasses.dataclass(frozen=True)
class LabelPropConfig:
    """Probabilistic label propagation (Util/ProbLabelPropagation.py:3-63,
    Laplacian: Util/Tool.py:435-467)."""

    alpha: float = 1.0
    beta: float = 1.0
    xyz_bandwidth: float = 1e3  # W_xyz = exp(-D * 1e3)
    rgb_bandwidth: float = 1e1  # W_rgb = exp(-D * 1e1)
    ridge: float = 1e-5
    degree_eps: float = 1e-8
    # "cg" (DEFAULT: factored-W CG — dense affinity, Laplacian never
    # materialized, tol early exit) | "solve" (batched dense LU, closest to
    # the reference's explicit tf.linalg.inv) | "cg_matfree" (CG, affinity
    # rows recomputed in the matvec — no [B,N,N] ever built; the 32k+/room
    # mode) | "sharded" (point-axis-sharded matrix-free CG over the mesh,
    # propagate/sharded.py).
    # CG hits rel-tol 1e-5 at ~12 iterations on trained-confidence inputs
    # and its argmax agrees with the LU solution on 99.97% of points
    # (identical synthetic-mIoU LP benefit, docs/kernels.md); cg_iters=50
    # is a safety CAP above the early exit, not a fixed count.
    solver: str = "cg"
    cg_iters: int = 50
    cg_tol: float = 1e-5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 6  # unique samples; Full style feeds 2x (Siamese pairs)
    epochs: int = 201
    rampup: int = 101
    style: str = "Full"  # "Plain" | "Full"
    label_fraction: float = 0.1  # -m flag
    eval_every: int = 5
    seed: int = 0
    num_devices: int = 1  # data-parallel mesh size
    # PRNG implementation for the training streams (dropout masks etc.).
    # "rbg" rides XLA's RngBitGenerator, cheaper than threefry mask
    # generation; its weaker split/fold_in independence guarantees are
    # irrelevant for dropout. Set "threefry2x32" for bit-reproducibility
    # with JAX's default streams. (Chosen on the previous accelerator;
    # not yet re-measured on a GPU.)
    rng_impl: str = "rbg"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    dataset: str = "ShapeNet"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    weaksup: WeakSupConfig = dataclasses.field(default_factory=WeakSupConfig)
    labelprop: LabelPropConfig = dataclasses.field(default_factory=LabelPropConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def shapenet_config(**overrides) -> ExperimentConfig:
    """Preset matching train_ShapeNet.py defaults + train_script:1-2."""
    model = ModelConfig(
        num_points=2048,
        in_channels=3,
        num_classes=50,
        k=20,
        knn_channels=None,
        use_transform_net=True,
        num_categories=16,
        head_channels=(256, 256, 128),
        head_keep_prob=(0.6, 0.6, None),
    )
    weaksup = WeakSupConfig(siamese_weight=1.0, smooth_channels=None)
    train = TrainConfig(batch_size=6, style="Full", label_fraction=0.1)
    cfg = ExperimentConfig(dataset="ShapeNet", model=model, weaksup=weaksup, train=train)
    return dataclasses.replace(cfg, **overrides)


def s3dis_config(**overrides) -> ExperimentConfig:
    """Preset matching train_S3DIS.py defaults + train_script:4-5."""
    model = ModelConfig(
        num_points=4096,
        in_channels=9,
        num_classes=13,
        k=20,
        knn_channels=(6, 9),
        use_transform_net=False,
        num_categories=0,
        head_channels=(512, 256),
        head_keep_prob=(None, 0.7),
        head_bn_fixed_decay=0.9,
    )
    weaksup = WeakSupConfig(siamese_weight=10.0, smooth_channels=(0, 6))
    train = TrainConfig(batch_size=3, style="Plain", label_fraction=0.1)
    cfg = ExperimentConfig(dataset="S3DIS", model=model, weaksup=weaksup, train=train)
    return dataclasses.replace(cfg, **overrides)
