"""Functional NN layers: shared-MLP "1x1 conv", batch norm, dropout, FC.

Equivalents of the reference layer wrappers
(Networks/dgcnn/utils/tf_util.py):

- ``conv2d`` with a [1,1] kernel (tf_util.py:115-173) is just a matmul over
  the channel axis — implemented as an einsum so XLA hands it to a GEMM
  and fuses bias/BN/ReLU around it.
- ``batch_norm_dist_template`` (tf_util.py:502-535): training normalizes with
  the *batch* moments and updates population stats with
  ``pop = pop * decay + batch * (1 - decay)``; eval normalizes with the
  population stats. Here the state is carried functionally (mean/var arrays
  in a state pytree, new state returned) instead of variable assignment.
  Under a data-parallel mesh the moments are computed over the *global*
  batch automatically: the reduction over the sharded batch axis lowers to a
  cross-replica collective under jit (the cross-replica-BN requirement from
  SURVEY.md section 2.3).
- ``dropout`` (tf_util.py:614-635): inverted dropout with keep_prob.

Params and BN stats are fp32; compute may run in bfloat16 (config).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Params = dict
State = dict

BN_EPS = 1e-3


def xavier_uniform(key, in_c: int, out_c: int, dtype=jnp.float32) -> jax.Array:
    """Glorot-uniform matching tf.contrib.layers.xavier_initializer for a
    [1,1,in,out] conv kernel (fan_in=in_c, fan_out=out_c)."""
    limit = jnp.sqrt(6.0 / (in_c + out_c))
    return jax.random.uniform(key, (in_c, out_c), dtype, -limit, limit)


def init_conv(key, in_c: int, out_c: int, *, bn: bool = True) -> Tuple[Params, State]:
    """Shared-MLP conv layer params (+ BN population stats if bn)."""
    params = {
        "w": xavier_uniform(key, in_c, out_c),
        "b": jnp.zeros((out_c,), jnp.float32),
    }
    if bn:
        params["beta"] = jnp.zeros((out_c,), jnp.float32)
        params["gamma"] = jnp.ones((out_c,), jnp.float32)
        state = {"mean": jnp.zeros((out_c,), jnp.float32),
                 "var": jnp.ones((out_c,), jnp.float32)}
    else:
        state = {}
    return params, state


def _batch_norm(x, params, state, *, training: bool, decay, eps: float = BN_EPS,
                axis_name=None):
    """Reference-semantics BN over all axes but the last. Returns (y, state).

    ``axis_name``: shard_map data-parallel axis — batch moments become
    cross-replica means (exact for equal shard sizes); autodiff of the
    pmean generates the matching backward collectives."""
    if training:
        x32 = x.astype(jnp.float32)
        axes = tuple(range(x.ndim - 1))
        # One-pass moments: E[x] and E[x^2] reduce in the SAME sweep over
        # the (large) activation tensor; the textbook two-pass
        # mean-then-centered-variance forces XLA to re-read it and
        # materialize the f32 centered tensor. Biased variance like
        # tf.nn.moments; f32 accumulation keeps E[x^2]-E[x]^2 cancellation
        # well under the BN epsilon (1e-3) for activation-scale data.
        mean = jnp.mean(x32, axis=axes)
        mean_sq = jnp.mean(jnp.square(x32), axis=axes)
        if axis_name is not None:
            mean = jax.lax.pmean(mean, axis_name)
            mean_sq = jax.lax.pmean(mean_sq, axis_name)
        var = jnp.maximum(mean_sq - jnp.square(mean), 0.0)
        new_state = {
            "mean": state["mean"] * decay + mean * (1.0 - decay),
            "var": state["var"] * decay + var * (1.0 - decay),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = jax.lax.rsqrt(var + eps) * params["gamma"]
    y = (x.astype(jnp.float32) - mean) * inv + params["beta"]
    return y.astype(x.dtype), new_state


def apply_conv(
    params: Params,
    state: State,
    x: jax.Array,
    *,
    training: bool,
    bn_decay=None,
    relu: bool = True,
    bn: bool = True,
    eps: float = BN_EPS,
    axis_name=None,
) -> Tuple[jax.Array, State]:
    """conv (channel matmul) + bias [+ BN] [+ ReLU]. x: [..., in_c]."""
    w = params["w"].astype(x.dtype)
    y = jnp.einsum("...i,io->...o", x, w, preferred_element_type=jnp.float32)
    y = y + params["b"]
    y = y.astype(x.dtype) if x.dtype != jnp.float32 else y
    if bn:
        y, state = _batch_norm(y, params, state, training=training,
                               decay=bn_decay, eps=eps, axis_name=axis_name)
    if relu:
        y = jax.nn.relu(y)
    return y, state


def apply_conv_bcast(
    params: Params,
    state: State,
    x_bcast: jax.Array,    # [B, Cg] per-sample features (global + category)
    x_point: jax.Array,    # [B, N, Cp] per-point features
    *,
    training: bool,
    bn_decay=None,
    eps: float = BN_EPS,
    axis_name=None,
) -> Tuple[jax.Array, State]:
    """conv over concat([broadcast_N(x_bcast), x_point]) WITHOUT the concat.

    The reference's first seg-head conv consumes the global feature tiled
    over every point (DGCNN_ShapeNet.py:87-100: tf.tile + concat). Since
    the broadcast rows are constant over N, the matmul splits as

        concat([tile(g), p]) @ W = broadcast_N(g @ W[:Cg]) + p @ W[Cg:]

    so the [B, N, Cg] tile and the [B, N, Cg+Cp] concat never exist in
    HBM — the g-part matmul runs once per sample and the broadcast-add
    fuses into the BN/relu pass. Identical math up to the contraction
    split's f32 reassociation.
    """
    w = params["w"]
    cg = x_bcast.shape[-1]
    wg = w[:cg].astype(x_bcast.dtype)
    wp = w[cg:].astype(x_point.dtype)
    yg = jnp.einsum("bi,io->bo", x_bcast, wg,
                    preferred_element_type=jnp.float32)
    yp = jnp.einsum("bni,io->bno", x_point, wp,
                    preferred_element_type=jnp.float32)
    y = yg[:, None, :] + yp + params["b"]
    y = y.astype(x_point.dtype) if x_point.dtype != jnp.float32 else y
    y, state = _batch_norm(y, params, state, training=training,
                           decay=bn_decay, eps=eps, axis_name=axis_name)
    return jax.nn.relu(y), state


@jax.custom_vjp
def edge_conv_matmul(f, nbr, w, b):
    """First EdgeConv conv: conv2d(concat([f_i, f_j - f_i])) + bias.

    Forward is literally the concat + einsum the straight path uses (XLA
    fuses the concat into the matmul; bit-identical outputs). The custom
    VJP exists for the BACKWARD: the mechanical transpose materializes the
    2C-wide edge-feature cotangent d_ef = dy @ W^T ([B, N, k, 2C] — 672 MB
    at the flagship shape) before splitting it; this one computes the
    exact same linear-map transpose factored as

        d_f   = (sum_k dy) @ (W_top - W_bot)^T          (k-reduce FIRST)
        d_nbr = dy @ W_bot^T                            (C-wide, not 2C)
        dW_top = f^T @ (sum_k dy)
        dW_bot = nbr^T(flat) @ dy - dW_top

    so nothing 2C-wide ever exists. Same math up to fp reassociation.
    """
    ef = jnp.concatenate(
        [jnp.broadcast_to(f[:, :, None, :], nbr.shape), nbr - f[:, :, None, :]],
        axis=-1)
    y = jnp.einsum("...i,io->...o", ef, w.astype(ef.dtype),
                   preferred_element_type=jnp.float32)
    return (y + b).astype(f.dtype) if f.dtype != jnp.float32 else y + b


def _edge_conv_matmul_fwd(f, nbr, w, b):
    return edge_conv_matmul(f, nbr, w, b), (f, nbr, w)


def _edge_conv_matmul_bwd(res, dy):
    f, nbr, w = res
    c = f.shape[-1]
    wc = w.astype(f.dtype)
    w_top, w_bot = wc[:c], wc[c:]
    # k-reduce FIRST, in f32 (20-term sums of bf16 cotangents)
    dy_sum = jnp.sum(dy.astype(jnp.float32), axis=2)  # [B, N, Cout]
    d_f = jnp.einsum("bno,io->bni", dy_sum.astype(dy.dtype), w_top - w_bot,
                     preferred_element_type=jnp.float32).astype(f.dtype)
    d_nbr = jnp.einsum("bnko,io->bnki", dy, w_bot,
                       preferred_element_type=jnp.float32).astype(nbr.dtype)
    dw_top = jnp.einsum("bnc,bno->co", f, dy_sum.astype(f.dtype),
                        preferred_element_type=jnp.float32)
    dw_nbr = jnp.einsum("bnkc,bnko->co", nbr, dy,
                        preferred_element_type=jnp.float32)
    dw = jnp.concatenate([dw_top, dw_nbr - dw_top], axis=0)
    db = jnp.sum(dy.astype(jnp.float32), axis=(0, 1, 2))
    return (d_f, d_nbr, dw.astype(w.dtype), db.astype(w.dtype))


edge_conv_matmul.defvjp(_edge_conv_matmul_fwd, _edge_conv_matmul_bwd)


def apply_edge_conv(
    params: Params,
    state: State,
    f: jax.Array,          # [B, N, C] point features
    nbr: jax.Array,        # [B, N, k, C] gathered neighbor features
    *,
    training: bool,
    bn_decay=None,
    eps: float = BN_EPS,
    axis_name=None,
) -> Tuple[jax.Array, State]:
    """conv(concat([f_i, f_j - f_i])) + bias + BN + ReLU with the
    d_ef-free backward (see edge_conv_matmul)."""
    y = edge_conv_matmul(f, nbr, params["w"], params["b"])
    y, state = _batch_norm(y, params, state, training=training,
                           decay=bn_decay, eps=eps, axis_name=axis_name)
    return jax.nn.relu(y), state


def apply_edge_conv_first(
    params: Params,
    state: State,
    f: jax.Array,          # [B, N, C] point features
    idx: jax.Array,        # int32 [B, N, k] neighbor indices
    *,
    training: bool,
    bn_decay=None,
    eps: float = BN_EPS,
    axis_name=None,
) -> Tuple[jax.Array, State]:
    """First conv of an EdgeConv stage without materializing edge features.

    conv(concat([f_i, f_j - f_i])) = f_i @ W_top + (f_j - f_i) @ W_bot
                                   = f_i @ (W_top - W_bot) + f_j @ W_bot
    so only the C_out-channel ``v = f @ W_bot`` needs gathering — half the
    bytes of the 2C edge tensor — and the two point-wise matmuls replace the
    k-times-larger edge matmul (~20x fewer FLOPs for C=64, k=20).
    Identical math to conv(edge_feature(...)) up to fp reassociation;
    BN + ReLU then run on the [B, N, k, C_out] pre-activations as before.
    """
    from weaksuppointcloudseg_tpu.ops.neighbors import gather_neighbors

    w = params["w"].astype(f.dtype)  # [2C, C_out]
    c = f.shape[-1]
    w_top, w_bot = w[:c], w[c:]
    u = jnp.einsum("...i,io->...o", f, w_top - w_bot,
                   preferred_element_type=jnp.float32)
    u = (u + params["b"]).astype(f.dtype)  # [B, N, C_out]
    v = jnp.einsum("...i,io->...o", f, w_bot,
                   preferred_element_type=jnp.float32).astype(f.dtype)
    v_nbr = gather_neighbors(v, idx)  # [B, N, k, C_out]
    y = u[:, :, None, :] + v_nbr
    y, state = _batch_norm(y, params, state, training=training,
                           decay=bn_decay, eps=eps, axis_name=axis_name)
    return jax.nn.relu(y), state


def dropout(x: jax.Array, rng, keep_prob: float, *, training: bool) -> jax.Array:
    """Inverted dropout matching tf.nn.dropout(keep_prob)."""
    if not training or keep_prob >= 1.0:
        return x
    keep = jax.random.bernoulli(rng, keep_prob, x.shape)
    return jnp.where(keep, x / keep_prob, 0.0).astype(x.dtype)
