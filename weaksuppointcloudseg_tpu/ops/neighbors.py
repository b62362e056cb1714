"""EdgeConv hot-loop ops: pairwise distance, kNN, neighbor gather.

Reimplementation of the reference op library
(Networks/dgcnn/utils/tf_util.py:638-706):

- ``pairwise_distance``: -2 X X^T + |x|^2 + |x|^2^T  -> B x N x N
- ``knn``: top_k(-adj, k)
- ``get_edge_feature``: flat gather + concat [x, x_j - x]

``knn_graph`` is the plain reference (dense distances + ``lax.top_k``).
``nearest_neighbors`` is what the model and the losses call: it lowers to
the fused distance + top-k Triton kernel (ops/knn_pallas.py) when compiled
for a CUDA device and to ``knn_graph`` everywhere else. The choice is made
per lowering platform, so a CPU computation inside a GPU process, and a
multi-platform export, each get the right path. Under a batch-sharded jit
(data parallelism) each device selects the neighbours of its own clouds:
a kernel call is opaque to XLA's partitioner, which would otherwise gather
the whole batch onto every device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental.custom_partitioning import custom_partitioning
from jax.extend.core import Primitive
from jax.interpreters import mlir
from jax.sharding import NamedSharding, PartitionSpec


def pairwise_sqdist(x: jax.Array) -> jax.Array:
    """Squared Euclidean pairwise distances.

    Args:
      x: [B, N, C] points (or features).

    Returns:
      [B, N, N] squared distances (up to fp error; diagonal ~ 0). Matches
      tf_util.pairwise_distance semantics (no clamping to >= 0).
    """
    # Precision.HIGHEST is required, not defensive: a reduced-precision
    # Gram (bf16 or TF32 inputs) puts ~1e-3-relative error on d^2, which
    # the exp(-1e3 d^2) label-propagation affinities amplify into garbage
    # (docs/kernels.md "precision").
    inner = jnp.einsum("bnc,bmc->bnm", x, x,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    sq = jnp.sum(jnp.square(x.astype(jnp.float32)), axis=-1)  # [B, N]
    return sq[:, :, None] - 2.0 * inner + sq[:, None, :]


def knn(sqdist: jax.Array, k: int) -> jax.Array:
    """Indices of the k nearest neighbors given squared distances.

    Matches tf_util.knn: ``top_k(-adj, k)`` — the self-point (distance 0)
    is included as the first neighbor.

    Args:
      sqdist: [B, N, N].
      k: number of neighbors.

    Returns:
      int32 [B, N, k] neighbor indices, nearest first.
    """
    _, idx = jax.lax.top_k(-sqdist, k)
    return idx


def knn_graph(x: jax.Array, k: int) -> jax.Array:
    """Pairwise distance + kNN in one call. [B, N, C] -> int32 [B, N, k]."""
    return knn(pairwise_sqdist(x), k)


def _knn_reference(x, *, k):
    neg, idx = jax.lax.top_k(-pairwise_sqdist(x), k)
    return idx, -neg


def _knn_kernel(x, *, k):
    from weaksuppointcloudseg_tpu.ops.knn_pallas import knn_pallas

    return knn_pallas(x, k, with_values=True)


def _knn_abstract_eval(x, *, k):
    b, n, _ = x.shape
    return (jax.core.ShapedArray((b, n, k), jnp.int32),
            jax.core.ShapedArray((b, n, k), jnp.float32))


_knn_p = Primitive("nearest_neighbors")
_knn_p.multiple_results = True
_knn_p.def_abstract_eval(_knn_abstract_eval)
mlir.register_lowering(
    _knn_p, mlir.lower_fun(_knn_reference, multiple_results=True))
mlir.register_lowering(
    _knn_p, mlir.lower_fun(_knn_kernel, multiple_results=True),
    platform="cuda")


def _per_cloud(mesh, sharding):
    # keep the operand's batch sharding; every cloud is whole on one device
    spec = getattr(sharding, "spec", PartitionSpec())
    return NamedSharding(mesh, PartitionSpec(spec[0] if len(spec) else None))


@partial(custom_partitioning, static_argnums=(1,))
def _knn_sharded(x, k):
    return tuple(_knn_p.bind(x, k=k))


def _knn_infer_sharding(k, mesh, arg_shapes, result_shape):
    out = _per_cloud(mesh, arg_shapes[0].sharding)
    return out, out


def _knn_partition(k, mesh, arg_shapes, result_shape):
    out = _per_cloud(mesh, arg_shapes[0].sharding)
    return mesh, lambda x: tuple(_knn_p.bind(x, k=k)), (out, out), (out,)


_knn_sharded.def_partition(
    infer_sharding_from_operands=_knn_infer_sharding,
    partition=_knn_partition,
    sharding_rule="b n c -> b n k, b n k")


@partial(jax.jit, static_argnames=("k", "with_values"))
def nearest_neighbors(x: jax.Array, k: int, *, with_values: bool = False):
    """The k nearest neighbours of every point, self included.

    Args:
      x: [B, N, C] points or features. No gradient flows through the
        selection (kNN is not differentiated anywhere in the pipeline).
      k: neighbour count.
      with_values: also return the selected squared distances.

    Returns:
      int32 [B, N, k] indices nearest first, ties to the lower index (the
      order of ``knn_graph``); with ``with_values`` the pair (indices,
      f32 [B, N, k] squared distances).
    """
    idx, sqd = _knn_sharded(jax.lax.stop_gradient(x), k)
    return (idx, sqd) if with_values else idx


@jax.custom_vjp
def gather_neighbors(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather per-point neighbor features.

    Args:
      x: [B, N, C].
      idx: int [B, N, k] indices into the N axis.

    Returns:
      [B, N, k, C] neighbor features.

    Forward is XLA's batched gather; the VJP is one scatter-add of the
    cotangent into a zero [B, N, C] buffer.
    """
    b, n, c = x.shape
    k = idx.shape[-1]
    flat_idx = idx.reshape(b, n * k)
    gathered = jnp.take_along_axis(x, flat_idx[..., None], axis=1)
    return gathered.reshape(b, n, k, c)


def _gather_fwd(x, idx):
    return gather_neighbors(x, idx), (idx, jnp.zeros_like(x))


def _gather_bwd(res, ct):
    idx, x_zeros = res
    bidx = jnp.arange(x_zeros.shape[0])[:, None, None]
    return x_zeros.at[bidx, idx].add(ct.astype(x_zeros.dtype)), None


gather_neighbors.defvjp(_gather_fwd, _gather_bwd)


def edge_feature(x: jax.Array, idx: jax.Array) -> jax.Array:
    """EdgeConv edge features: concat([x_i, x_j - x_i]).

    Matches tf_util.get_edge_feature (tf_util.py:674-706).

    Args:
      x: [B, N, C] point features.
      idx: int [B, N, k] neighbor indices.

    Returns:
      [B, N, k, 2C].
    """
    neighbors = gather_neighbors(x, idx)  # [B, N, k, C]
    central = jnp.broadcast_to(x[:, :, None, :], neighbors.shape)
    return jnp.concatenate([central, neighbors - central], axis=-1)
