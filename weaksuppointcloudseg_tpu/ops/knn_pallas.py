"""Fused pairwise-distance + k-nearest-neighbour kernel (Pallas, Triton route).

The reference builds the dense B x N x N distance matrix in device memory
and runs a generic top-k over it (tf_util.py:638-671); under XLA a dot does
not fuse into a top-k, so every graph writes and re-reads [B, N, N] f32
(1.07 GB at B=64, N=2048). This kernel never materialises it.

One program owns one (cloud, tile of ``tm`` query rows). It streams the
cloud's points in tiles of ``tn`` candidates and keeps, per query row, the
running k best (squared distance, index) pairs in registers, so no state
crosses program boundaries:

- distances are ``|q|^2 - 2 q.c + |c|^2`` with the dot in IEEE f32
  (``allow_tf32=False``) -- the reference formula (ops/neighbors.py::
  pairwise_sqdist), so the indices agree with ``knn_graph`` except where
  two distances tie within f32 rounding;
- a candidate tile costs only as many selection rounds as the largest
  number of its entries in one row that beat that row's current k-th best
  (at most k): after the first tiles the running bound is tight and most
  tiles take few rounds;
- each round moves a row's best remaining candidate into the slot of its
  current worst entry; ties resolve towards the lower index, exactly like
  ``lax.top_k`` on ``-d``. The final k are emitted nearest first.

Padded candidates carry ``|c|^2 = +inf`` and so are never selected; padded
query rows produce rows the wrapper slices off. Channels are zero-padded to
a power of two of at least 16 (the dot's smallest operand width), which
cannot change a squared distance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# query rows per program, candidates per streamed tile, warps per program
ROW_TILE = 32
COL_TILE = 128
NUM_WARPS = 4

_BIG_INDEX = 2**30


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _knn_kernel(x_ref, sq_ref, idx_ref, val_ref, *, k: int, tm: int, tn: int,
                n_tiles: int):
    kp = idx_ref.shape[-1]
    row0 = pl.program_id(1) * tm
    q = x_ref[pl.ds(row0, tm), :]                   # [tm, cp] f32
    sq_q = sq_ref[pl.ds(row0, tm)]                  # [tm]
    slot = jax.lax.broadcasted_iota(jnp.int32, (tm, kp), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (tm, tn), 1)
    # slots >= k hold -inf so they are never the row's worst entry
    vals = jnp.where(slot < k, jnp.inf, -jnp.inf).astype(jnp.float32)
    idxs = jnp.full((tm, kp), _BIG_INDEX, jnp.int32)

    def tile(j, carry):
        vals, idxs = carry
        c = x_ref[pl.ds(j * tn, tn), :]             # [tn, cp]
        sq_c = sq_ref[pl.ds(j * tn, tn)]            # [tn]
        inner = pl.dot(q, c, trans_b=True, allow_tf32=False)
        d = sq_q[:, None] - 2.0 * inner + sq_c[None, :]
        worst = jnp.max(vals, axis=1)
        better = (d < worst[:, None]).astype(jnp.int32)
        rounds = jnp.minimum(jnp.max(jnp.sum(better, axis=1)), k)

        def select(_, st):
            d, vals, idxs, worst = st
            m = jnp.min(d, axis=1)
            p = jnp.argmin(d, axis=1).astype(jnp.int32)
            # evict the worst entry; among equal values the higher index
            # loses, as in lax.top_k
            evict = jnp.argmax(
                jnp.where(vals == worst[:, None], idxs, -1), axis=1
            ).astype(jnp.int32)
            put = (slot == evict[:, None]) & (m < worst)[:, None]
            vals = jnp.where(put, m[:, None], vals)
            idxs = jnp.where(put, (j * tn + p)[:, None], idxs)
            d = jnp.where(col == p[:, None], jnp.inf, d)
            return d, vals, idxs, jnp.max(vals, axis=1)

        _, vals, idxs, _ = jax.lax.fori_loop(
            0, rounds, select, (d, vals, idxs, worst))
        return vals, idxs

    vals, idxs = jax.lax.fori_loop(0, n_tiles, tile, (vals, idxs))

    # emit nearest first; among equal distances the lower index first
    vals = jnp.where(slot < k, vals, jnp.inf)
    out_v = jnp.full((tm, kp), jnp.inf, jnp.float32)
    out_i = jnp.zeros((tm, kp), jnp.int32)
    for t in range(k):
        m = jnp.min(vals, axis=1)
        sel = jnp.min(jnp.where(vals == m[:, None], idxs, _BIG_INDEX), axis=1)
        out_v = jnp.where(slot == t, m[:, None], out_v)
        out_i = jnp.where(slot == t, sel[:, None], out_i)
        vals = jnp.where(idxs == sel[:, None], jnp.inf, vals)
    idx_ref[...] = out_i
    val_ref[...] = out_v


@functools.partial(jax.jit,
                   static_argnames=("k", "with_values", "interpret"))
def knn_pallas(x: jax.Array, k: int, *, with_values: bool = False,
               interpret: bool = False):
    """k nearest neighbours of every point of every cloud.

    Args:
      x: [B, N, C] points or features, any float dtype (distances are
        computed in f32).
      k: neighbour count, self included (like tf_util.knn); ``k <= N``.
      with_values: also return the selected squared distances.
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns:
      int32 [B, N, k] indices, nearest first; with ``with_values`` the
      pair (indices, f32 [B, N, k] squared distances).
    """
    b, n, c = x.shape
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= N, got k={k}, N={n}")
    tm, tn = ROW_TILE, COL_TILE
    n_pad = _round_up(n, max(tm, tn))
    cp = max(16, _next_pow2(c))
    kp = _next_pow2(k)
    x = x.astype(jnp.float32)
    sq = jnp.sum(jnp.square(x), axis=-1)
    x = jnp.pad(x, ((0, 0), (0, n_pad - n), (0, cp - c)))
    sq = jnp.pad(sq, ((0, 0), (0, n_pad - n)), constant_values=jnp.inf)
    kernel = functools.partial(_knn_kernel, k=k, tm=tm, tn=tn,
                               n_tiles=n_pad // tn)
    idx, vals = pl.pallas_call(
        kernel,
        grid=(b, n_pad // tm),
        in_specs=[
            pl.BlockSpec((None, n_pad, cp), lambda bi, i: (bi, 0, 0)),
            pl.BlockSpec((None, n_pad), lambda bi, i: (bi, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, tm, kp), lambda bi, i: (bi, i, 0)),
            pl.BlockSpec((None, tm, kp), lambda bi, i: (bi, i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, n_pad, kp), jnp.int32),
            jax.ShapeDtypeStruct((b, n_pad, kp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        backend="triton",
        interpret=interpret,
        name="knn_topk",
    )(x, sq)
    idx = idx[:, :n, :k]
    if with_values:
        return idx, vals[:, :n, :k]
    return idx
