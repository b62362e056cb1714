"""Point-axis-sharded label propagation (the context-parallel analog).

For very large clouds the dense N x N Laplacian stops fitting one device's
memory comfortably (SURVEY.md §5 "long-context" row: a 4096^2 f32 matrix is
64 MB per sample — and the reference's closed-form solve is O(N^3)). This
module shards the *point axis* across the device mesh with ``shard_map``:

- each device holds a row block of the affinity/Laplacian matrix
  [B, N/D, N] — built locally from a replicated copy of the points;
- the symmetric normalization (the reference's test-path variant,
  Util/Tool.py:435-467) needs the global degree vector — ONE [B, N]
  all-gather; the unnormalized variant (:402-433) needs none;
- the LP system is solved matrix-free with conjugate gradient where the
  matvec is row-local (one [B, N, K] all-gather of the iterate) and the CG
  scalars reduce with ``psum``.

This trades the O(N^3) factorization for O(iters * N^2 / D) work and cuts
per-device memory from N^2 to N^2 / D. Reached from the test CLIs via
``LabelPropConfig(solver="sharded")`` (propagate_batch dispatches here).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from weaksuppointcloudseg_tpu.propagate.label_prop import entropy_confidence


def _affinity_rows(x_rows, x_all, rgb_rows, rgb_all, *, xyz_bandwidth,
                   rgb_bandwidth):
    """W row block [B, n_local, N] (product kernel, Util/Tool.py:443-459)."""

    def sqd(a, b):
        # HIGHEST: reduced-precision (bf16 / TF32) matmuls corrupt exp(-1e3 d^2)
        # affinities (see ops/neighbors.py::pairwise_sqdist)
        inner = jnp.einsum("blc,bnc->bln", a, b,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        return (jnp.sum(a * a, -1)[..., :, None] - 2.0 * inner
                + jnp.sum(b * b, -1)[..., None, :])

    return jnp.exp(-(jnp.maximum(sqd(x_rows, x_all), 0.0) * xyz_bandwidth
                     + jnp.maximum(sqd(rgb_rows, rgb_all), 0.0)
                     * rgb_bandwidth))


def label_propagation_sharded(
    mesh: Mesh,
    x: jax.Array,    # [B, N, C] (or [N, C]) points
    g: jax.Array,    # [B, N, K] (or [N, K]) predicted probabilities
    rgb: Optional[jax.Array] = None,
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
    ridge: float = 1e-5,
    degree_eps: float = 1e-8,
    cg_iters: int = 50,
    sym: bool = True,
) -> jax.Array:
    """Y_prob via point-axis-sharded CG. The mesh size must divide N.

    ``sym=True`` (default) solves with the symmetric-normalized Laplacian —
    the variant the reference's test path uses (Util/Tool.py:435-467) — at
    the cost of one [B, N] degree all-gather; ``sym=False`` uses the
    unnormalized Laplacian (:402-433), which needs no degree exchange.
    The system A = alpha L + beta diag(w) + ridge I is SPD either way.
    """
    squeeze = x.ndim == 2
    if squeeze:
        x, g = x[None], g[None]
        rgb = None if rgb is None else rgb[None]
    if rgb is None:
        rgb = x
    axis = mesh.axis_names[0]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, None), P(None, axis), P(None, None),
                  P(None, axis), P(None, None)),
        out_specs=P(None, axis),
        check_vma=False,
    )
    def solve(x_rows, x_all, rgb_rows, rgb_all, g_rows, g_all):
        w_aff = _affinity_rows(
            x_rows, x_all, rgb_rows, rgb_all,
            xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth,
        )  # [B, n_local, N]
        d_rows = jnp.sum(w_aff, axis=-1)  # local row degrees [B, n_local]
        b, n_local, n = w_aff.shape
        shard = jax.lax.axis_index(axis)
        rows = shard * n_local + jnp.arange(n_local)
        col = jax.lax.broadcasted_iota(jnp.int32, (n_local, n), 1)
        on_diag = col == rows[:, None]  # [n_local, N]

        # L rows = diag(d + eps) - W
        lap_rows = jnp.where(
            on_diag, d_rows[..., None] + degree_eps - w_aff, -w_aff)
        if sym:
            # one [B, N] collective buys the global degrees for the
            # column scaling; row scaling is local
            d_all = jax.lax.all_gather(d_rows, axis, axis=1, tiled=True)
            s_all = jax.lax.rsqrt(jnp.maximum(d_all, 1e-30))  # [B, N]
            s_rows = s_all[:, rows]
            lap_rows = (s_rows[..., None] * lap_rows * s_all[:, None, :])

        w_conf = entropy_confidence(g_all)  # replicated [B, N]
        w_rows = w_conf[:, rows]
        a_rows = alpha * lap_rows + jnp.where(
            on_diag, beta * w_rows[..., None] + ridge, 0.0)

        b_rows = beta * w_rows[..., None] * g_rows  # rhs rows (the closed
        # form multiplies by beta outside the inverse AND uses diag(w) G —
        # identical algebra to label_prop.py)

        def matvec(v_rows):
            # v is sharded by rows; the matvec needs all of v
            v_full = jax.lax.all_gather(v_rows, axis, axis=1, tiled=True)
            return jnp.einsum("bln,bnk->blk", a_rows, v_full,
                              preferred_element_type=jnp.float32)

        def pdot(u, v):  # global inner product of sharded vectors
            return jax.lax.psum(jnp.sum(u * v), axis)

        # conjugate gradient on the sharded rows
        x0 = jnp.zeros_like(b_rows)
        r0 = b_rows - matvec(x0)
        p0 = r0
        rs0 = pdot(r0, r0)

        def body(_, carry):
            xk, rk, pk, rsk = carry
            ap = matvec(pk)
            alpha_k = rsk / jnp.maximum(pdot(pk, ap), 1e-30)
            xk = xk + alpha_k * pk
            rk = rk - alpha_k * ap
            rs_new = pdot(rk, rk)
            pk = rk + (rs_new / jnp.maximum(rsk, 1e-30)) * pk
            return xk, rk, pk, rs_new

        y_rows, _, _, _ = jax.lax.fori_loop(0, cg_iters, body,
                                            (x0, r0, p0, rs0))
        # row-normalize: the denominator is row-local (sum over K)
        denom = jnp.sum(y_rows, axis=-1, keepdims=True)
        return y_rows / jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)

    out = solve(x, x, rgb, rgb, g, g)
    return out[0] if squeeze else out
