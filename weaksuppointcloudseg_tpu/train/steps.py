"""Jitted train / eval step factories.

These are the equivalents of the reference's per-batch ``sess.run``
blocks (ShapeNet/ShapeNet_DGCNN_trainer.py:308-314 and the loss graph at
:88-133): one pure function per (style, config) that XLA compiles once and
replays every step.

Design notes:
- Everything dynamic between steps (step counter, rampup gate, rng key) is a
  *runtime input*, so the jit cache holds exactly one executable per config.
  This also fixes quirk Q1 (the reference's rampup gate is a frozen graph
  constant 0.0; here the gate is a fed scalar, with the frozen behavior
  available via ``WeakSupConfig.compat_frozen_gate``).
- The LR / BN-decay staircase schedules are computed *inside* the step from
  the step counter (ops/schedules.py) — no host round-trip.
- Batches arrive sharded over the mesh batch axis (parallel/mesh.py). Two
  data-parallel modes:
  (a) XLA-partitioner (what the trainers use): the loss / BN
      mean-reductions span the sharded axis, so the compiler inserts the
      collectives (gradient all-reduce + cross-replica BN) automatically —
      covered by the DP equivalence test;
  (b) explicit shard_map (``make_train_step(..., mesh=...)``): every BN
      pmeans its moments over ``axis_name``, losses/metrics reduce
      globally, and per-shard partial grads are reduced — validated
      against the single-device step by tests/test_shardmap_dp.py.
- ``state`` buffers are donated — params/optimizer state update in place in
  device memory.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from weaksuppointcloudseg_tpu.configs import ExperimentConfig
from weaksuppointcloudseg_tpu.losses.weaksup import (
    masked_softmax_ce,
    total_weaksup_loss,
)
from weaksuppointcloudseg_tpu.models.dgcnn import apply_dgcnn_seg
from weaksuppointcloudseg_tpu.ops.schedules import (
    learning_rate_schedule,
    bn_decay_schedule,
)
from weaksuppointcloudseg_tpu.train.state import TrainState


def make_forward_fn(cfg: ExperimentConfig) -> Callable:
    """Raw forward pass closure over the static model config."""

    def forward(params, bn_state, x, cat_onehot, *, training, bn_decay, rng,
                axis_name=None):
        return apply_dgcnn_seg(
            params, bn_state, x, cat_onehot,
            cfg=cfg.model, training=training, bn_decay=bn_decay, rng=rng,
            head_bn_fixed_decay=cfg.model.head_bn_fixed_decay,
            axis_name=axis_name,
        )

    return forward


def _loss_fn(params, bn_state, batch, *, cfg, style, bn_decay, gate, rng,
             axis_name=None):
    forward = make_forward_fn(cfg)
    logits, new_bn_state = forward(
        params, bn_state, batch["data"], batch.get("cat_onehot"),
        training=True, bn_decay=bn_decay, rng=rng, axis_name=axis_name,
    )
    if style == "Full":
        w = cfg.weaksup
        total, components = total_weaksup_loss(
            logits, batch["seg_onehot"], batch["mask"], batch["data"],
            gate=gate, siamese_weight=w.siamese_weight,
            smooth_gamma=w.smooth_gamma, smooth_knn=w.smooth_knn,
            smooth_channels=w.smooth_channels,
            compat_frozen_gate=w.compat_frozen_gate,
            axis_name=axis_name,
        )
    else:
        total = masked_softmax_ce(logits, batch["seg_onehot"], batch["mask"],
                                  axis_name=axis_name)
        components = {"seg": total}
    components["total"] = total
    return total, (components, new_bn_state, logits)


def _accuracy(logits, seg_labels, valid_mask, part_bias=None,
              axis_name=None):
    """Fraction of correctly classified points over valid samples.

    ``part_bias`` [B, K] (1.0 on the shape category's part ids) reproduces
    the reference's category-biased train argmax — Z_prob[:, iou_oids] += 1
    before argmax (ShapeNet_DGCNN_trainer.py:199-201)."""
    prob = jax.nn.softmax(logits, axis=-1)
    if part_bias is not None:
        prob = prob + part_bias[:, None, :]
    pred = jnp.argmax(prob, axis=-1)
    correct = (pred == seg_labels).astype(jnp.float32) * valid_mask[:, None]
    num = jnp.sum(correct)
    den = jnp.sum(valid_mask) * seg_labels.shape[1]
    if axis_name is not None:
        num = jax.lax.psum(num, axis_name)
        den = jax.lax.psum(den, axis_name)
    return num / jnp.maximum(den, 1.0)


def make_train_step(cfg: ExperimentConfig, style: Optional[str] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Build the jitted train step.

    The returned function has signature
        (state, batch, gate, rng) -> (state, metrics)
    with ``batch`` a dict of device arrays:
        data        [B, N, C]       (Full style: B = 2 * unique, interleaved)
        seg_onehot  [B, N, K]
        seg         [B, N] int      (for the accuracy metric)
        mask        [B, N]          labelled-point mask
        cat_onehot  [B, num_categories] (ShapeNet only)
        valid       [B]             1.0 for real samples, 0 for padding
    and ``gate`` the rampup gate scalar (epoch >= rampup ? 1.0 : 0.0).

    ``mesh``: build the step as an explicit ``shard_map`` over the mesh's
    first axis instead of relying on the SPMD partitioner. Every BN takes
    ``axis_name`` and pmeans its moments; the losses/metrics reduce
    globally (psum'd numerator/denominator for the masked CE, pmean
    elsewhere) and the per-shard partial gradients are reduced before the
    optimizer update. Requires every batch leaf's leading dim to
    divide the mesh size. Dropout keys are decorrelated per shard via
    ``fold_in(axis_index)`` — statistically equivalent to, but not
    bit-identical with, the single-device masks.
    """
    style = style or cfg.train.style
    # The schedules count UNIQUE samples: the reference passes args.batchsize
    # (not the 2x Siamese feed size) to SetLearningRate even in Full style
    # (train_ShapeNet.py:82, ShapeNet_DGCNN_trainer.py:26-44).
    batch_size = cfg.train.batch_size
    axis = mesh.axis_names[0] if mesh is not None else None

    def _step(state: TrainState, batch, gate, rng):
        lr = learning_rate_schedule(state.step, batch_size, cfg.schedule)
        bn_decay = bn_decay_schedule(state.step, batch_size, cfg.schedule)
        if axis is not None:
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        grad_fn = jax.value_and_grad(_loss_fn, has_aux=True)
        (_, (components, new_bn_state, logits)), grads = grad_fn(
            state.params, state.bn_state, batch,
            cfg=cfg, style=style, bn_decay=bn_decay, gate=gate, rng=rng,
            axis_name=axis,
        )
        if axis is not None:
            # The loss is evaluated with GLOBAL reductions, so the true
            # per-shard grad is a partial contribution and the completing
            # reduction would be a psum. But under check_vma=False,
            # shard_map transposes psum to psum (the conservative rule),
            # so differentiating the replicated global loss inflates every
            # shard's cotangent by the axis size D: each shard's grad is
            # D x partial, and the completing reduction is a pmean.
            # (Validated leaf-for-leaf against the single-device step by
            # tests/test_shardmap_dp.py — which pins these semantics: if a
            # jax upgrade switches to the pbroadcast transpose, that test
            # fails loudly and this becomes a psum.)
            grads = jax.lax.pmean(grads, axis)
        new_state = state.replace(bn_state=new_bn_state).apply_gradients(grads, lr)
        metrics = dict(components)
        metrics["lr"] = lr
        metrics["bn_decay"] = bn_decay
        metrics["acc"] = _accuracy(
            logits, batch["seg"], batch["valid"], batch.get("part_bias"),
            axis_name=axis,
        )
        return new_state, metrics

    if mesh is None:
        return partial(jax.jit, donate_argnums=(0,))(_step)

    sharded = shard_map(
        _step, mesh=mesh,
        in_specs=(P(), P(axis), P(), P()),
        out_specs=(P(), P()),
        # outputs are value-replicated by construction (global reductions)
        check_vma=False,
    )
    return partial(jax.jit, donate_argnums=(0,))(sharded)


def make_eval_logits_fn(cfg: ExperimentConfig) -> Callable:
    """Inference logits closure: ``(state, x, cat_onehot=None) -> logits
    [B, N, C]`` with population BN stats and no dropout (NOT jitted —
    callers jit or compose it). ``make_eval_step`` and both trainers' test
    loops route through it."""
    forward = make_forward_fn(cfg)

    def logits_fn(state: TrainState, x, cat_onehot=None):
        logits, _ = forward(
            state.params, state.bn_state, x, cat_onehot,
            training=False, bn_decay=None, rng=jax.random.PRNGKey(0),
        )
        return logits

    return logits_fn


def make_eval_step(cfg: ExperimentConfig,
                   mesh: Optional[Mesh] = None) -> Callable:
    """Build the jitted eval forward: (state, batch) -> (prob, loss).

    Runs with training=False — population BN stats, no dropout. (The
    reference's Plain-style eval runs with Is_Training=True, quirk Q7; the
    sound Full-style eval path is what this reproduces.)

    ``mesh``: shard_map over the batch axis (population BN stats make eval
    trivially shard-local; only the masked CE reduces globally).
    Probabilities come back batch-sharded.
    """

    logits_fn = make_eval_logits_fn(cfg)
    axis = mesh.axis_names[0] if mesh is not None else None

    def _eval(state: TrainState, batch):
        logits = logits_fn(state, batch["data"], batch.get("cat_onehot"))
        loss = masked_softmax_ce(logits, batch["seg_onehot"], batch["mask"],
                                 axis_name=axis)
        return jax.nn.softmax(logits, axis=-1), loss

    if mesh is None:
        return jax.jit(_eval)

    return jax.jit(shard_map(
        _eval, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(axis), P()),
        check_vma=False,
    ))
