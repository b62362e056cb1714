"""Probabilistic label propagation (inference-time refinement).

Rebuild of Util/ProbLabelPropagation.py:3-63 (``LabelPropagation_TF``):

    w_i = 1 - H(G_i) / log2(K)                 (entropy confidence, :31-42)
    Y   = beta * (alpha L + beta diag(w) + 1e-5 I)^-1 diag(w) G      (:21-23)
    Y_prob = Y / sum_k Y                                              (:23)

Differences from the reference:
- The explicit ``tf.linalg.inv`` + matmul is replaced by a batched linear
  solve (one LU per sample instead of a full inverse — ~3x fewer FLOPs and
  better conditioned). A matrix-free conjugate-gradient mode avoids the
  O(N^3) factorization when the Laplacian is applied on the fly.
- Everything is batched [B, N, ...] and jittable; the reference solves one
  sample at a time through a feed_dict.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def entropy_confidence(g: jax.Array) -> jax.Array:
    """Per-point confidence w = 1 - H(g)/log2(K).

    Args:
      g: [..., N, K] predicted probabilities.

    Returns:
      [..., N] weights. Matches ProbLabelPropagation.py:31-42 including the
      +1e-5 inside the log (which lets w go slightly negative for near-uniform
      predictions — kept for parity).
    """
    k = g.shape[-1]
    entropy = -jnp.sum(g * jnp.log2(g + 1e-5), axis=-1)
    return 1.0 - entropy / jnp.log2(jnp.asarray(float(k), g.dtype))


@partial(jax.jit, static_argnames=("solver", "cg_iters", "cg_tol"))
def label_propagation(
    lap: jax.Array,
    g: jax.Array,
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    ridge: float = 1e-5,
    solver: str = "solve",
    cg_iters: int = 50,
    cg_tol: float = 1e-5,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Closed-form label propagation.

    Args:
      lap: [B, N, N] (symmetric-normalized) graph Laplacians.
      g: [B, N, K] predicted probabilities.
      solver: "solve" (batched LU) or "cg" (matrix-free conjugate gradient —
        the system is symmetric and, for w >= 0, positive definite).

    Returns:
      (Y [B, N, K], Y_prob row-normalized, w [B, N]).
    """
    b, n, _ = lap.shape
    w = entropy_confidence(g)  # [B, N]
    rhs = w[..., None] * g  # diag(w) @ G

    if solver == "cg":
        # matvec straight off the Laplacian — the system matrix
        # a = alpha L + beta diag(w) + ridge I is never materialized
        diag = beta * w + ridge  # [B, N]

        def matvec(v):
            lv = jnp.einsum("bnm,bmk->bnk", lap, v,
                            preferred_element_type=jnp.float32)
            return alpha * lv + diag[..., None] * v

        y, _ = jax.scipy.sparse.linalg.cg(matvec, rhs, maxiter=cg_iters,
                                          tol=cg_tol)
        y = beta * y
    else:
        eye = jnp.eye(n, dtype=lap.dtype)
        a = alpha * lap + beta * w[..., :, None] * eye + ridge * eye
        y = beta * jnp.linalg.solve(a, rhs)

    denom = jnp.sum(y, axis=-1, keepdims=True)
    y_prob = y / jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)
    return y, y_prob, w


@partial(jax.jit, static_argnames=(
    "alpha", "beta", "xyz_bandwidth", "rgb_bandwidth", "ridge",
    "degree_eps", "cg_iters", "cg_tol"))
def label_propagation_factored(
    xyz: jax.Array,   # [B, N, Cx]
    g: jax.Array,     # [B, N, K]
    rgb: jax.Array,   # [B, N, Cr]
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
    ridge: float = 1e-5,
    degree_eps: float = 1e-8,
    cg_iters: int = 50,
    cg_tol: float = 1e-5,
) -> jax.Array:
    """Dense-affinity CG without ever materializing the Laplacian.

    Same math as laplacian_xyz_rgb(sym=True) + label_propagation(solver=
    "cg") — the reference's closed-form system (ProbLabelPropagation.py:
    21-23 with the Tool.py:435-467 symmetric Laplacian) — but the system
    matrix is kept FACTORED: only the affinity W [B,N,N] is built (one
    write), and the matvec applies

        A v = [alpha (d+eps) s^2 + beta w_conf + ridge] v - alpha s (W (s v))

    with s = d^-1/2. Building L = S(D-W)S would cost two extra full
    [B,N,N] passes (write L, then CG reads L instead of W) for zero
    information.
    """
    from weaksuppointcloudseg_tpu.propagate.laplacian import (
        product_kernel_weights,
    )

    w = product_kernel_weights(
        xyz, rgb, xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth)
    d = jnp.sum(w, axis=-1)  # degrees [B, N]
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-30))
    w_conf = entropy_confidence(g)
    diag = alpha * (d + degree_eps) * s * s + beta * w_conf + ridge

    def matvec(v):
        wv = jnp.einsum("bnm,bmk->bnk", w, s[..., None] * v,
                        preferred_element_type=jnp.float32)
        return diag[..., None] * v - alpha * s[..., None] * wv

    rhs = w_conf[..., None] * g
    y, _ = jax.scipy.sparse.linalg.cg(matvec, rhs, maxiter=cg_iters,
                                      tol=cg_tol)
    y = beta * y
    denom = jnp.sum(y, axis=-1, keepdims=True)
    return y / jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for t in range(min(cap, n), 0, -1):
        if n % t == 0:
            return t
    return 1


@partial(jax.jit, static_argnames=(
    "alpha", "beta", "xyz_bandwidth", "rgb_bandwidth", "ridge",
    "degree_eps", "cg_iters", "cg_tol", "row_tile"))
def label_propagation_matfree(
    xyz: jax.Array,   # [B, N, Cx]
    g: jax.Array,     # [B, N, K]
    rgb: jax.Array,   # [B, N, Cr]
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
    ridge: float = 1e-5,
    degree_eps: float = 1e-8,
    cg_iters: int = 50,
    cg_tol: float = 1e-5,
    row_tile: int = 512,
) -> jax.Array:
    """Genuinely matrix-free LP: CG where the affinity row block is
    recomputed inside every matvec, so no [B,N,N] array ever exists — peak
    extra memory is one [B, T, N] tile. Same semantics as the dense
    symmetric-normalized solve (Util/Tool.py:435-467 +
    ProbLabelPropagation.py:21-23): trades O(iters) recomputation of the
    Gram/exp for O(N^2) -> O(T*N) memory; the mode for clouds whose dense
    Laplacian would not fit HBM.

    Shaping (docs/kernels.md "room-LP"):
    - the xyz/rgb Grams FOLD into one 6-channel Gram on
      bandwidth-pre-scaled features (exp(-(bx*dx + br*dr)) =
      exp(-sqd([sqrt(bx) x, sqrt(br) rgb])));
    - the Gram runs at Precision.HIGHEST: a reduced-precision (bf16 or
      TF32) Gram puts ~1e-3-relative error on d^2, which the exp(-1e3 d^2)
      kernel amplifies to e^(+-10) garbage on meter-scale room coords;
    - the tile is applied transposed, accumulating out^T [B,K,N] over row
      tiles via u_tile^T [K,T] @ W_rows [T,N] (W is symmetric).
    """
    b, n, _ = xyz.shape
    t = _largest_divisor_at_most(n, row_tile)
    n_tiles = n // t

    # distances are translation-invariant; centering shrinks |x|^2 and
    # with it the f32 cancellation error of the Gram trick (room-scale
    # coords x bandwidth 1e3 sit right at f32's edge). Caller contract:
    # any caller-side pad points must sit NEAR the real cloud (e.g.
    # room_label_prop pads 2 m outside the room) — far-flung pads drag
    # the mean away from the real points and reintroduce exactly the
    # cancellation error the centering removes.
    feat = jnp.concatenate(
        [xyz * jnp.sqrt(jnp.float32(xyz_bandwidth)),
         rgb * jnp.sqrt(jnp.float32(rgb_bandwidth))], axis=-1)  # [B,N,6]
    feat = feat - jnp.mean(feat, axis=1, keepdims=True)

    sq = jnp.sum(feat * feat, axis=-1)  # [B, N]

    def w_rows(i):
        """Affinity rows [i*t, (i+1)*t): [B, T, N]."""
        rf = jax.lax.dynamic_slice_in_dim(feat, i * t, t, axis=1)
        rsq = jax.lax.dynamic_slice_in_dim(sq, i * t, t, axis=1)
        inner = jnp.einsum("btc,bnc->btn", rf, feat,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        d = jnp.maximum(
            rsq[..., :, None] - 2.0 * inner + sq[..., None, :], 0.0)
        return jnp.exp(-d)

    def apply_w(u):  # [B, N, K] -> W @ u, one [B, T, N] affinity tile
        # materialized per row tile
        k = u.shape[-1]

        def body(i, acc):
            wt = w_rows(i)
            ut = jax.lax.dynamic_slice_in_dim(u, i * t, t, axis=1)
            return acc + jnp.einsum("btk,btn->bkn", ut, wt,
                                    preferred_element_type=jnp.float32)

        out_t = jax.lax.fori_loop(
            0, n_tiles, body, jnp.zeros((b, k, n), jnp.float32))
        return jnp.swapaxes(out_t, 1, 2)

    d = apply_w(jnp.ones((b, n, 1), xyz.dtype))[..., 0]  # degrees [B, N]
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-30))
    w_conf = entropy_confidence(g)
    diag = alpha * (d + degree_eps) * s * s + beta * w_conf + ridge  # [B, N]

    def matvec(v):
        # A v = alpha Lsym v + (beta w + ridge) v with
        # Lsym v = s (d+eps) s v - s W (s v)
        return diag[..., None] * v - alpha * s[..., None] * apply_w(
            s[..., None] * v)

    rhs = w_conf[..., None] * g
    # Jacobi preconditioner: diag(A) is exactly `diag` — free to apply and
    # shaves iterations where the confidence weights vary point-to-point
    y, _ = jax.scipy.sparse.linalg.cg(
        matvec, rhs, maxiter=cg_iters, tol=cg_tol,
        M=lambda v: v / diag[..., None])
    y = beta * y
    denom = jnp.sum(y, axis=-1, keepdims=True)
    return y / jnp.where(jnp.abs(denom) < 1e-30, 1.0, denom)


def propagate_batch(
    xyz: jax.Array,
    g: jax.Array,
    rgb: Optional[jax.Array] = None,
    *,
    alpha: float = 1.0,
    beta: float = 1.0,
    xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
    ridge: float = 1e-5,
    solver: str = "cg",
    cg_iters: int = 50,
    cg_tol: float = 1e-5,
) -> jax.Array:
    """Laplacian build + LP solve in one jitted call. Returns Y_prob [B,N,K].

    ShapeNet passes rgb=None (the reference feeds xyz twice,
    ShapeNet_DGCNN_trainer.py:551); S3DIS passes the RGB channels
    (S3DIS_DGCNN_trainer.py:543).

    Solvers: "cg" (the default: factored-W CG — dense affinity, Laplacian
    never materialized, tol-based early exit; label_propagation_factored),
    "solve" (batched dense LU — bitwise-closest to the reference's explicit
    inverse), "cg_matfree" (no [B,N,N] ever built — the 32k+ long-context
    mode), "sharded" (point-axis-sharded matrix-free CG over the device
    mesh, propagate/sharded.py).
    """
    if rgb is None:
        rgb = xyz
    if solver == "cg":
        return label_propagation_factored(
            xyz, g, rgb, alpha=alpha, beta=beta,
            xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth,
            ridge=ridge, cg_iters=cg_iters, cg_tol=cg_tol,
        )
    if solver == "cg_matfree":
        return label_propagation_matfree(
            xyz, g, rgb, alpha=alpha, beta=beta,
            xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth,
            ridge=ridge, cg_iters=cg_iters, cg_tol=cg_tol,
        )
    if solver == "sharded":
        import jax as _jax

        from weaksuppointcloudseg_tpu.parallel.mesh import cached_mesh
        from weaksuppointcloudseg_tpu.propagate.sharded import (
            label_propagation_sharded,
        )

        # the point axis is split over the mesh: use the largest device
        # count that divides N (a 3000-point cloud on a 16-device host
        # gets an 8-device mesh, not a crash). The mesh is cached per
        # device count — the per-room S3DIS loop calls this once per block
        # batch and must not rebuild the Mesh each time.
        n = xyz.shape[-2]
        d = _largest_divisor_at_most(n, len(_jax.devices()))
        mesh = cached_mesh(d)
        return label_propagation_sharded(
            mesh, xyz, g, rgb, alpha=alpha, beta=beta,
            xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth,
            ridge=ridge, cg_iters=cg_iters, sym=True,
        )

    from weaksuppointcloudseg_tpu.propagate.laplacian import laplacian_xyz_rgb

    lap = laplacian_xyz_rgb(
        xyz, rgb, sym=True,
        xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth,
    )
    _, y_prob, _ = label_propagation(
        lap, g, alpha=alpha, beta=beta, ridge=ridge,
        solver=solver, cg_iters=cg_iters, cg_tol=cg_tol,
    )
    return y_prob
