"""Graph-Laplacian builders for label propagation.

Rebuild of the reference's placeholder-graph calculators
(Util/Tool.py:400-467, classes ``LaplacianMat_XYZRGB_DirectComp`` /
``LaplacianMatSym_XYZRGB_DirectComp``):

    W    = exp(-D_xyz * 1e3) * exp(-D_rgb * 1e1)       (negative D clamped to 0)
    d    = sum_j W_ij
    L    = diag(d + 1e-8) - W                          (unnormalized)
    Lsym = diag(d^-1/2) (diag(d + 1e-8) - W) diag(d^-1/2)

ShapeNet calls the symmetric variant with (xyz, xyz) — no color
(ShapeNet/ShapeNet_DGCNN_trainer.py:551); S3DIS with (xyz, rgb)
(S3DIS/S3DIS_DGCNN_trainer.py:543).

The two Gram matrices are batched matmuls at full f32 precision; the exp /
product / row-sum fuse into their epilogue under XLA. Rather than materializing the
diagonal degree matrices and doing two more N x N matmuls like the reference,
the symmetric normalization is applied as a rank-1 row/column scaling
(outer product of d^-1/2), which is bandwidth-, not compute-, bound.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from weaksuppointcloudseg_tpu.ops.neighbors import pairwise_sqdist


def product_kernel_weights(
    xyz: jax.Array,
    rgb: jax.Array,
    *,
    xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
) -> jax.Array:
    """Affinity W = exp(-D_xyz * bw_xyz) * exp(-D_rgb * bw_rgb), [B, N, N].

    The reference clamps negative fp error in the squared distances to zero
    before the exp (Util/Tool.py:449,457) — reproduced here.
    """
    d_xyz = jnp.maximum(pairwise_sqdist(xyz), 0.0)
    d_rgb = jnp.maximum(pairwise_sqdist(rgb), 0.0)
    # Single exp of the summed scaled distances (= product of the two exps).
    return jnp.exp(-(d_xyz * xyz_bandwidth + d_rgb * rgb_bandwidth))


@partial(jax.jit, static_argnames=("sym", "xyz_bandwidth", "rgb_bandwidth"))
def laplacian_xyz_rgb(
    xyz: jax.Array,
    rgb: jax.Array,
    *,
    sym: bool = True,
    xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
    degree_eps: float = 1e-8,
) -> jax.Array:
    """Batched (optionally symmetric-normalized) graph Laplacian [B, N, N].

    Matches Util/Tool.py:435-467 (sym) / :402-433 (unnormalized).
    """
    w = product_kernel_weights(
        xyz, rgb, xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth
    )
    # both XYZRGB variants add the diagonal epsilon (Tool.py:429-430 unnorm,
    # :462-464 sym), unlike the generic LaplacianMat
    return laplacian_from_weights(
        w, sym=sym, degree_eps=degree_eps, eps_always=True)


# --- generic calculators (Util/Tool.py:297-400, TF_Computation inner
# classes: InnerProd / PairDist2 / PairWeight2 / LaplacianMat[Sym] /
# LaplacianMatSym_DirectComp). The reference builds one placeholder graph
# per calculator; here each is a plain jittable function. Dormant in the
# reference (only the XYZRGB direct-comp pair is on the live path) —
# rebuilt for completeness. ---


def inner_prod(x: jax.Array, y: jax.Array) -> jax.Array:
    """Batched Gram matrix X Y^T (Tool.py:297-306). [B,N,C]x[B,M,C]->[B,N,M]."""
    return jnp.einsum("bnc,bmc->bnm", x, y,
                      preferred_element_type=jnp.float32)


def pair_dist2(x: jax.Array) -> jax.Array:
    """Clamped squared pairwise distances (Tool.py:310-327)."""
    return jnp.maximum(pairwise_sqdist(x), 0.0)


def pair_weight2(x: jax.Array, gamma: float) -> jax.Array:
    """Gaussian affinity exp(-D/gamma) on clamped distances (Tool.py:331-349)."""
    return jnp.exp(-pair_dist2(x) / gamma)


def laplacian_from_weights(
    w: jax.Array, *, sym: bool = False, degree_eps: float = 1e-8,
    eps_always: bool = False,
) -> jax.Array:
    """L = diag(d [+ eps]) - W, optionally symmetric-normalized
    (Tool.py:352-383, LaplacianMat / LaplacianMatSym).

    Epsilon semantics reproduce the reference exactly: the generic
    unnormalized LaplacianMat adds NO diagonal epsilon (Tool.py:355-358)
    while the sym variant adds 1e-8 (:370-373); the XYZRGB direct-comp
    builders add it in BOTH variants (``eps_always``, :429-430, :462-464).
    """
    d = jnp.sum(w, axis=-1)  # [B, N]
    n = w.shape[-1]
    eye = jnp.eye(n, dtype=w.dtype)
    add = degree_eps if (sym or eps_always) else 0.0
    lap = (d + add)[..., None] * eye - w
    if not sym:
        return lap
    d_negsqrt = jax.lax.rsqrt(jnp.maximum(d, 1e-30))  # [B, N]
    return lap * d_negsqrt[..., :, None] * d_negsqrt[..., None, :]


def laplacian_sym_direct(x: jax.Array, *, bandwidth: float = 1e3,
                         degree_eps: float = 1e-8) -> jax.Array:
    """Symmetric-normalized Laplacian straight from points with the fixed
    exp(-D * 1e3) kernel (Tool.py:385-400, LaplacianMatSym_DirectComp)."""
    w = jnp.exp(-pair_dist2(x) * bandwidth)
    return laplacian_from_weights(w, sym=True, degree_eps=degree_eps)
