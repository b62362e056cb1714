"""Dormant smoothness-constraint variants (completeness rebuild).

The live pipeline only uses ``Loss_SpatialColorSmooth_add_SelfContain``
(rebuilt as losses/weaksup.py::smooth_knn_laplacian). The reference ships
three more variants that nothing imports (Util/SmoothConstraint.py:9-128,
169-219); they are rebuilt here with the same unit-test treatment the
dormant Util/Loss.py alternates got (losses/alternates.py) so a user
migrating experiments has the full menu.

All run through the shared op library (ops/neighbors.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from weaksuppointcloudseg_tpu.ops.neighbors import (
    gather_neighbors,
    pairwise_sqdist,
)


def spatial_smooth(x: jax.Array, w: jax.Array, idx: jax.Array) -> jax.Array:
    """Precomputed-graph spatial smoothness (SmoothConstraint.py:9-33,
    ``Loss_SpatialSmooth``): mean_{b,n,j} w * sum_c (x_i - x_j)^2.

    Args:
      x: [B, N, C] point cloud.
      w: [B, N, k] kNN edge weights.
      idx: int [B, N, k] kNN indices.
    """
    x_nbr = gather_neighbors(x, idx)
    diff2 = jnp.sum(jnp.square(x[:, :, None, :] - x_nbr), axis=-1)
    return jnp.mean(w * diff2)


def _knn_weights(d: jax.Array, gamma: float, k: int):
    """exp(topk(-D)/gamma) + indices, the clamped-distance kNN weights."""
    d = jnp.maximum(d, 0.0)  # the reference zeroes negative fp error
    neg_topk, idx = jax.lax.top_k(-d, k)
    return jnp.exp(neg_topk / gamma), idx


def spatial_smooth_self_contained(
    x: jax.Array,
    *,
    gamma: float = 1e-1,
    k: int = 5,
    compat_scalar_sum: bool = False,
) -> jax.Array:
    """Self-contained spatial smoothness on the input cloud itself
    (SmoothConstraint.py:36-68, ``Loss_SpatialSmooth_SelfContain``).

    The reference's released code computes
    ``W * tf.reduce_sum((X_exp - X_til)**2)`` with NO axis argument
    (SmoothConstraint.py:65) — the squared differences collapse to one
    scalar that multiplies every weight, i.e. loss =
    sum(W) * sum(diff^2) / (B*N*k). That is almost certainly a bug (the
    sibling variants reduce over the channel axis only); the default here
    implements the evident intent, and ``compat_scalar_sum=True``
    reproduces the released behavior bit-for-bit.
    """
    w, idx = _knn_weights(pairwise_sqdist(x), gamma, k)
    x_nbr = gather_neighbors(x, idx)
    diff2 = jnp.square(x[:, :, None, :] - x_nbr)
    if compat_scalar_sum:
        b, n, _ = x.shape
        return jnp.sum(w) * jnp.sum(diff2) / (b * n * k)
    return jnp.mean(w * jnp.sum(diff2, axis=-1))


def spatial_color_smooth_self_contained(
    z: jax.Array,
    x: jax.Array,
    *,
    gamma: float = 1e-1,
    k: int = 10,
) -> jax.Array:
    """Two-graph (xyz AND rgb) smoothness with an agreement mask
    (SmoothConstraint.py:70-128, ``Loss_SpatialColorSmooth_SelfContain``).

    Separate kNN graphs are built on xyz (x[..., 0:3]) and rgb
    (x[..., 3:6]); only edges where the two graphs agree slot-for-slot
    (Ind_xyz == Ind_rgb) contribute, weighted by each graph's own Gaussian
    weight:

        loss = mean[ mask * W_xyz * ||z_i - z_{xyz nbr}||^2
                   + mask * W_rgb * ||z_i - z_{rgb nbr}||^2 ]
    """
    w_xyz, idx_xyz = _knn_weights(pairwise_sqdist(x[..., 0:3]), gamma, k)
    w_rgb, idx_rgb = _knn_weights(pairwise_sqdist(x[..., 3:6]), gamma, k)
    mask = (idx_xyz == idx_rgb).astype(z.dtype)

    def edge_term(idx):
        z_nbr = gather_neighbors(z, idx)
        return jnp.sum(jnp.square(z[:, :, None, :] - z_nbr), axis=-1)

    loss = mask * (w_xyz * edge_term(idx_xyz) + w_rgb * edge_term(idx_rgb))
    return jnp.mean(loss)


def spatial_color_smooth_unknown_batch(
    z: jax.Array,
    x: jax.Array,
    *,
    gamma: float = 1e-1,
    k: int = 10,
) -> jax.Array:
    """Fully vectorized single-graph variant (SmoothConstraint.py:169-219,
    ``Loss_SpatialColorSmoothAdd_UnknownBatch_SelfContain``): one distance
    on ALL channels of x, weights straight from ``top_k`` values (no
    per-batch gather loop), loss = mean(W * sum_c (z_i - z_j)^2).

    This is the vectorization the live variant should have used — it is
    the same math as losses/weaksup.py::smooth_knn_laplacian except the
    channel reduction is a sum, not a mean.
    """
    w, idx = _knn_weights(pairwise_sqdist(x), gamma, k)
    z_nbr = gather_neighbors(z, idx)
    diff2 = jnp.sum(jnp.square(z[:, :, None, :] - z_nbr), axis=-1)
    return jnp.mean(w * diff2)
