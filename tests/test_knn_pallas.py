"""Fused distance + top-k Triton kernel (ops/knn_pallas.py) against the plain
reference ``knn_graph``: the kernel in interpret mode on the CPU, the
platform choice of ``nearest_neighbors``, and (``gpu`` marker) the compiled
kernel on a card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from weaksuppointcloudseg_tpu.ops.knn_pallas import knn_pallas
from weaksuppointcloudseg_tpu.ops.neighbors import (
    knn_graph,
    nearest_neighbors,
    pairwise_sqdist,
)


def assert_same_neighbors(x, k, idx, vals):
    """Indices equal the reference's except where two candidates' f32
    distances tie within rounding; returned distances match the
    reference's distances of the returned indices."""
    d = np.asarray(pairwise_sqdist(x))
    want = np.asarray(knn_graph(x, k))
    idx, vals = np.asarray(idx), np.asarray(vals)
    sq = np.asarray(jnp.sum(jnp.square(x.astype(jnp.float32)), -1))
    # rounding bound of the |q|^2 - 2 q.c + |c|^2 formula in f32
    tol = 64 * np.finfo(np.float32).eps * (
        sq[..., None] + sq.max(-1)[:, None, None])
    d_got = np.take_along_axis(d, idx, -1)
    d_want = np.take_along_axis(d, want, -1)
    not_tie = (idx != want) & (np.abs(d_got - d_want) > tol)
    assert not not_tie.any(), f"{int(not_tie.sum())} non-tie mismatches"
    assert (np.abs(vals - d_got) <= tol).all()


@pytest.mark.parametrize(
    "b,n,c,k",
    [
        (2, 256, 3, 20),    # ShapeNet xyz graph (scaled down)
        (1, 300, 7, 10),    # N not a tile multiple + odd C
        (2, 200, 64, 20),   # feature-space graphs
        (1, 128, 9, 5),     # S3DIS-style input
        (2, 160, 6, 10),    # S3DIS smoothness loss channels (xyzrgb)
        (1, 129, 3, 20),    # one point past a whole tile
        (1, 100, 3, 17),    # k not a power of two
        (2, 64, 3, 1),      # k=1: each point's own index
        (2, 250, 6, 10),    # smoothness loss k with a masked tail
        (1, 512, 64, 20),   # several row and candidate tiles at C=64
    ],
)
def test_matches_reference(rng, b, n, c, k):
    x = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32)
    idx, vals = knn_pallas(x, k, with_values=True, interpret=True)
    assert idx.shape == (b, n, k) and vals.shape == (b, n, k)
    assert_same_neighbors(x, k, idx, vals)


def test_bfloat16_features(rng):
    """bf16 features are upcast exactly; products of bf16 values are exact
    in f32, so only the summation order differs from the reference."""
    x = jnp.asarray(rng.standard_normal((2, 192, 64)),
                    jnp.float32).astype(jnp.bfloat16)
    idx, vals = knn_pallas(x, 20, with_values=True, interpret=True)
    assert_same_neighbors(x, 20, idx, vals)


def test_self_is_first_neighbor(rng):
    x = jnp.asarray(rng.standard_normal((1, 128, 3)), jnp.float32)
    idx = np.asarray(knn_pallas(x, 4, interpret=True))
    np.testing.assert_array_equal(idx[0, :, 0], np.arange(128))


def test_duplicate_points_tie_break(rng):
    """Exact duplicates must resolve by lowest index, like lax.top_k —
    also when the tied candidates sit in different candidate tiles."""
    x = rng.standard_normal((1, 300, 3)).astype(np.float32)
    x[0, 10] = x[0, 3]
    x[0, 140] = x[0, 3]
    x[0, 290] = x[0, 3]
    got = np.asarray(knn_pallas(jnp.asarray(x), 5, interpret=True))
    want = np.asarray(knn_graph(jnp.asarray(x), 5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 290, :4], [3, 10, 140, 290])


def test_padded_candidates_never_selected(rng):
    """N=130 pads to 256 candidates; the pads carry |c|^2=inf. Even with
    k equal to N every real point is returned exactly once."""
    n = 130
    x = jnp.asarray(rng.standard_normal((1, n, 3)), jnp.float32)
    idx = np.asarray(knn_pallas(x, n, interpret=True))
    assert idx.max() < n
    np.testing.assert_array_equal(np.sort(idx[0], axis=-1),
                                  np.tile(np.arange(n), (n, 1)))


@pytest.mark.parametrize("k", [0, 33])
def test_k_out_of_range_raises(k):
    with pytest.raises(ValueError, match="k <= N"):
        knn_pallas(jnp.zeros((1, 32, 3)), k, interpret=True)


@pytest.mark.parametrize("platform,kernel", [("cpu", False), ("cuda", True)])
def test_platform_choice(platform, kernel):
    """``nearest_neighbors`` lowers to the Triton kernel for CUDA and to
    the plain reference elsewhere; a CPU host can lower for both."""
    x = jnp.zeros((2, 64, 3), jnp.float32)
    hlo = jax.jit(lambda x: nearest_neighbors(x, 8)).trace(x).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("knn_topk" in hlo) == kernel
    assert ("triton" in hlo) == kernel


def test_nearest_neighbors_is_the_reference_on_cpu(rng):
    x = jnp.asarray(rng.standard_normal((2, 96, 3)), jnp.float32)
    idx, vals = nearest_neighbors(x, 8, with_values=True)
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.asarray(knn_graph(x, 8)))
    # values within the f32 rounding of the distance formula: the jitted
    # primitive may fuse |q|^2 - 2 q.c + |c|^2 in another order
    assert_same_neighbors(x, 8, idx, vals)


def test_batch_sharded_jit_keeps_clouds_local(rng):
    """Under a batch-sharded jit each device selects the neighbours of its
    own clouds: no device builds the whole batch's distances."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    x = jnp.asarray(rng.standard_normal((8, 64, 3)), jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    f = jax.jit(lambda x: nearest_neighbors(x, 8, with_values=True))
    idx, vals = f(xs)
    assert idx.sharding.is_equivalent_to(xs.sharding, 3)
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.asarray(knn_graph(x, 8)))
    assert_same_neighbors(x, 8, idx, vals)
    hlo = f.lower(xs).compile().as_text()
    assert "f32[2,64,64]" in hlo and "f32[8,64,64]" not in hlo


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 64])
def test_compiled_kernel_matches_reference(rng, c):
    x = jnp.asarray(rng.standard_normal((4, 1000, c)), jnp.float32)
    idx, vals = knn_pallas(x, 20, with_values=True)
    assert_same_neighbors(x, 20, idx, vals)
