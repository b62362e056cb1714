"""Loss-function unit tests against numpy closed forms and hand cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weaksuppointcloudseg_tpu.losses import (
    masked_softmax_ce,
    siamese_consistency,
    mil_inexact,
    smooth_knn_laplacian,
    total_weaksup_loss,
)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def test_masked_ce_matches_numpy(rng):
    B, N, K = 3, 16, 5
    logits = rng.normal(size=(B, N, K)).astype(np.float32)
    labels = rng.integers(0, K, size=(B, N))
    onehot = np.eye(K, dtype=np.float32)[labels]
    mask = (rng.random((B, N)) < 0.3).astype(np.float32)
    mask[0, 0] = 1.0  # ensure nonzero
    p = _softmax(logits)
    ce = -np.log(np.take_along_axis(p, labels[..., None], axis=-1)[..., 0])
    want = np.sum(mask * ce) / np.sum(mask)
    got = float(masked_softmax_ce(jnp.asarray(logits), jnp.asarray(onehot), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_masked_ce_zero_mask_is_finite():
    logits = jnp.zeros((2, 4, 3))
    onehot = jnp.zeros((2, 4, 3))
    mask = jnp.zeros((2, 4))
    assert np.isfinite(float(masked_softmax_ce(logits, onehot, mask)))


def test_siamese_zero_for_identical_pairs(rng):
    p = rng.random((4, 8, 5)).astype(np.float32)
    prob = np.repeat(p, 2, axis=0)  # interleaved identical pairs
    assert float(siamese_consistency(jnp.asarray(prob))) == 0.0


def test_siamese_matches_numpy(rng):
    prob = rng.random((6, 8, 5)).astype(np.float32)
    want = np.mean(np.sum((prob[0::2] - prob[1::2]) ** 2, axis=-1))
    got = float(siamese_consistency(jnp.asarray(prob)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mil_matches_numpy(rng):
    B, N, K = 3, 16, 7
    logits = rng.normal(size=(B, N, K)).astype(np.float32)
    labels = rng.integers(0, K, size=(B, N))
    onehot = np.eye(K, dtype=np.float32)[labels]
    z = onehot.max(axis=1)
    x = logits.max(axis=1)
    want = np.mean(np.maximum(x, 0) - x * z + np.log1p(np.exp(-np.abs(x))))
    got = float(mil_inexact(jnp.asarray(logits), jnp.asarray(onehot)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def np_smooth_loss(prob, x, gamma=0.1, k=10, d=None):
    B, N, K = prob.shape
    if d is None:
        diff = x[:, :, None, :] - x[:, None, :, :]
        d = np.maximum(np.sum(diff**2, axis=-1), 0.0)
    acc = 0.0
    for b in range(B):
        for n in range(N):
            order = np.argsort(d[b, n], kind="stable")[:k]
            w = np.exp(-d[b, n][order] / gamma)
            diff2 = np.mean((prob[b, n][None, :] - prob[b][order]) ** 2, axis=-1)
            acc += np.sum(w * diff2)
    return acc / (B * N * k)


def test_smooth_loss_matches_numpy(rng):
    B, N, K = 2, 24, 5
    prob = _softmax(rng.normal(size=(B, N, K)).astype(np.float32))
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    # Use the op's own (gram-based) distance so fp tie-ordering in the top-k
    # matches; the numpy loop then independently checks weights/gather/mean.
    from weaksuppointcloudseg_tpu.ops import pairwise_sqdist

    d = np.maximum(np.asarray(pairwise_sqdist(jnp.asarray(x))), 0.0)
    want = np_smooth_loss(prob, x, gamma=0.1, k=6, d=d)
    got = float(smooth_knn_laplacian(jnp.asarray(prob), jnp.asarray(x), gamma=0.1, k=6))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)


def test_smooth_loss_zero_for_constant_prob(rng):
    x = rng.normal(size=(2, 16, 3)).astype(np.float32)
    prob = np.ones((2, 16, 4), dtype=np.float32) / 4
    got = float(smooth_knn_laplacian(jnp.asarray(prob), jnp.asarray(x), k=5))
    assert got == 0.0


def test_smooth_loss_channel_slice(rng):
    # S3DIS passes xyzrgb cols 0:6 of a 9-channel input
    x9 = rng.normal(size=(2, 16, 9)).astype(np.float32)
    prob = _softmax(rng.normal(size=(2, 16, 4)).astype(np.float32))
    a = float(smooth_knn_laplacian(jnp.asarray(prob), jnp.asarray(x9), k=5, channels=(0, 6)))
    b = float(smooth_knn_laplacian(jnp.asarray(prob), jnp.asarray(x9[..., :6]), k=5))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_total_loss_gate(rng):
    B, N, K = 4, 16, 5
    logits = jnp.asarray(rng.normal(size=(B, N, K)).astype(np.float32))
    labels = rng.integers(0, K, size=(B, N))
    onehot = jnp.asarray(np.eye(K, dtype=np.float32)[labels])
    mask = jnp.ones((B, N))
    x = jnp.asarray(rng.normal(size=(B, N, 3)).astype(np.float32))
    t0, comps0 = total_weaksup_loss(logits, onehot, mask, x, gate=jnp.asarray(0.0))
    t1, comps1 = total_weaksup_loss(logits, onehot, mask, x, gate=jnp.asarray(1.0))
    np.testing.assert_allclose(float(t0), float(comps0["seg"]), rtol=1e-6)
    want = float(comps1["seg"] + comps1["siamese"] + comps1["inexact"] + comps1["smooth"])
    np.testing.assert_allclose(float(t1), want, rtol=1e-6)


def test_losses_differentiable(rng):
    B, N, K = 4, 16, 5
    logits = jnp.asarray(rng.normal(size=(B, N, K)).astype(np.float32))
    labels = rng.integers(0, K, size=(B, N))
    onehot = jnp.asarray(np.eye(K, dtype=np.float32)[labels])
    mask = jnp.ones((B, N))
    x = jnp.asarray(rng.normal(size=(B, N, 3)).astype(np.float32))

    def f(lg):
        t, _ = total_weaksup_loss(lg, onehot, mask, x, gate=jnp.asarray(1.0))
        return t

    g = jax.grad(f)(logits)
    assert np.all(np.isfinite(np.asarray(g)))


def _np_smooth_grad(prob, idx, w):
    """d loss / d prob of mean_{b,n,j} w_nj * mean_K (P_n - P_idx[n,j])^2."""
    b, n, k = idx.shape
    scale = 2.0 / (b * n * k * prob.shape[-1])
    g = np.zeros_like(prob)
    for bi in range(b):
        diff = prob[bi][:, None, :] - prob[bi][idx[bi]]      # [N, k, K]
        term = scale * w[bi][..., None] * diff
        g[bi] += term.sum(axis=1)
        np.add.at(g[bi], idx[bi].reshape(-1), -term.reshape(-1, prob.shape[-1]))
    return g


@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("preset", ["shapenet", "s3dis"])
def test_smooth_loss_at_preset_channels(rng, preset, n):
    """The plain smoothness loss on each preset's input and channel slice
    (ShapeNet: xyz of a 3-channel input; S3DIS: xyzrgb, columns 0:6 of 9)
    with its k and gamma: value and gradient against float64 NumPy."""
    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.ops import pairwise_sqdist

    cfg = getattr(configs, f"{preset}_config")()
    w, m = cfg.weaksup, cfg.model
    x = rng.normal(size=(2, n, m.in_channels)).astype(np.float32)
    prob = _softmax(rng.normal(size=(2, n, m.num_classes))).astype(
        np.float32)
    lo, hi = w.smooth_channels or (0, m.in_channels)
    # the op's own distances fix the neighbour order (ties included); the
    # weights, the gather and the means are checked independently
    d = np.asarray(pairwise_sqdist(jnp.asarray(x[..., lo:hi])), np.float64)
    idx = np.argsort(d, axis=-1, kind="stable")[..., :w.smooth_knn]
    wts = np.exp(-np.maximum(np.take_along_axis(d, idx, -1), 0.0)
                 / w.smooth_gamma)
    p64 = prob.astype(np.float64)
    want = np_smooth_loss(p64, x, gamma=w.smooth_gamma, k=w.smooth_knn,
                          d=np.maximum(d, 0.0))

    def loss(p):
        return smooth_knn_laplacian(
            p, jnp.asarray(x), gamma=w.smooth_gamma, k=w.smooth_knn,
            channels=w.smooth_channels)

    got, grad = jax.value_and_grad(loss)(jnp.asarray(prob))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    g_want = _np_smooth_grad(p64, idx, wts)
    np.testing.assert_allclose(np.asarray(grad), g_want, rtol=1e-4,
                               atol=1e-6 * np.abs(g_want).max())
