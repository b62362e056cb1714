"""The plain EdgeConv stage (neighbour gather -> 1 or 2 convs with BN and
ReLU -> max over the k neighbours), as the model composes it, against a
float64 NumPy reference: forward values and the gradients of every
parameter and of the input features (central finite differences). Also
the ``gather_neighbors`` VJP against autodiff of ``take_along_axis``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from weaksuppointcloudseg_tpu.models import layers
from weaksuppointcloudseg_tpu.ops.neighbors import gather_neighbors

B, N, K, C = 2, 24, 6, 4
EPS = 1e-3
# relative L2 error limits. float32: reassociation only. bfloat16:
# activations are rounded to 8 bits of mantissa between the layers, and
# a rounding can flip which neighbour wins a k-max (the gradient then
# lands on another neighbour); the weight gradients sum such terms with
# cancelling signs (up to 0.15 seen). An identically-zero gradient, the
# fault this guards against in bf16, is an error of 1.
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.25}


def _np_stage(f, idx, convs, training):
    b = np.arange(f.shape[0])[:, None, None]
    nbr = f[b, idx]                                         # [B, N, k, C]
    ctr = np.broadcast_to(f[:, :, None, :], nbr.shape)
    h = np.concatenate([ctr, nbr - ctr], axis=-1)
    for p, s in convs:
        y = h @ p["w"] + p["b"]
        if training:
            mean, var = y.mean(axis=(0, 1, 2)), y.var(axis=(0, 1, 2))
        else:
            mean, var = s["mean"], s["var"]
        h = np.maximum((y - mean) / np.sqrt(var + EPS) * p["gamma"]
                       + p["beta"], 0.0)
    return h.max(axis=2)


def _jax_stage(params, states, f, idx, *, training, first):
    kw = dict(training=training, bn_decay=0.9, eps=EPS)
    if first == "edge_conv":
        h, _ = layers.apply_edge_conv(params[0], states[0], f,
                                      gather_neighbors(f, idx), **kw)
    else:
        h, _ = layers.apply_edge_conv_first(params[0], states[0], f, idx,
                                            **kw)
    for p, s in zip(params[1:], states[1:]):
        h, _ = layers.apply_conv(p, s, h, **kw)
    return jnp.max(h, axis=2)


def _setup(rng, widths):
    params, states = [], []
    c = 2 * C
    for i, w in enumerate(widths):
        p, s = layers.init_conv(jax.random.PRNGKey(i), c, w)
        p = {k: np.asarray(v, np.float64) for k, v in p.items()}
        p["b"] = 0.1 * rng.standard_normal(w)
        p["gamma"] = 1.0 + 0.2 * rng.standard_normal(w)
        p["beta"] = 0.1 * rng.standard_normal(w)
        s = {"mean": 0.1 * rng.standard_normal(w),
             "var": 0.5 + rng.uniform(size=w)}
        params.append(p)
        states.append(s)
        c = w
    f = rng.standard_normal((B, N, C))
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[:, :, 0] = np.arange(N)          # self first, like a kNN graph
    r = rng.standard_normal((B, N, widths[-1]))
    return params, states, f, idx, r


def _fd_grad(loss, x, h=1e-6):
    g = np.zeros_like(x)
    flat, gflat = x.reshape(-1), g.reshape(-1)
    for i in range(flat.size):
        keep = flat[i]
        flat[i] = keep + h
        up = loss()
        flat[i] = keep - h
        down = loss()
        flat[i] = keep
        gflat[i] = (up - down) / (2 * h)
    return g


def _rel(got, want, scale):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), scale))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", [(16,), (16, 8)], ids=["1conv", "2conv"])
@pytest.mark.parametrize("first", ["edge_conv", "edge_conv_first"])
def test_stage_matches_float64_reference(rng, first, widths, dtype,
                                         training):
    params, states, f, idx, r = _setup(rng, widths)
    convs = list(zip(params, states))
    want = _np_stage(f, idx, convs, training)

    jp = [{k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
          for p in params]
    js = [{k: jnp.asarray(v, jnp.float32) for k, v in s.items()}
          for s in states]
    jf = jnp.asarray(f, jnp.float32).astype(dtype)
    jidx = jnp.asarray(idx)

    def loss(jp, jf):
        out = _jax_stage(jp, js, jf, jidx, training=training, first=first)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, out), (g_p, g_f) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jp, jf)
    assert out.dtype == jnp.dtype(dtype)
    assert out.shape == (B, N, widths[-1])
    assert _rel(out, want, 1e-30) <= FWD_TOL[dtype]

    def np_loss():
        return float(np.sum(_np_stage(f, idx, convs, training) * r))

    # conv biases feeding a training-mode BN have no true gradient (the
    # batch mean absorbs them): theirs is rounding noise, bounded on the
    # whole gradient's scale
    g_all = []
    for i, p in enumerate(params):
        for name in ("w", "b", "gamma", "beta"):
            g_all.append((f"conv{i}.{name}", np.asarray(g_p[i][name]),
                          _fd_grad(np_loss, p[name])))
    g_all.append(("features", np.asarray(g_f, np.float32),
                  _fd_grad(np_loss, f)))
    scale = np.sqrt(sum(np.sum(w ** 2) for _, _, w in g_all) / len(g_all))
    for name, got, want_g in g_all:
        assert np.isfinite(got).all(), name
        absorbed = training and name.endswith(".b")
        err = _rel(got, want_g, (1e-1 if absorbed else 1e-2) * scale)
        assert err <= GRAD_TOL[dtype], f"{name}: rel L2 {err:.2e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,k,c", [(2, 16, 4, 3), (1, 33, 20, 8),
                                     (3, 10, 10, 5)])
def test_gather_vjp_matches_take_along_axis(rng, b, n, k, c, dtype):
    """Forward equals the flat ``take_along_axis`` gather bit for bit; the
    custom scatter-add VJP equals its autodiff, including rows that pick
    the same neighbour several times and points no row picks."""
    x = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32).astype(
        dtype)
    idx = rng.integers(0, max(n // 2, 1), (b, n, k)).astype(np.int32)
    idx[:, 0, :] = 0                       # one row: k copies of point 0
    idx = jnp.asarray(idx)
    ct = jnp.asarray(rng.standard_normal((b, n, k, c)),
                     jnp.float32).astype(dtype)

    def plain(x):
        flat = jnp.take_along_axis(x, idx.reshape(b, n * k)[..., None],
                                   axis=1)
        return flat.reshape(b, n, k, c)

    got, vjp_got = jax.vjp(lambda x: gather_neighbors(x, idx), x)
    want, vjp_want = jax.vjp(plain, x)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))
    (dx_got,), (dx_want,) = vjp_got(ct), vjp_want(ct)
    assert dx_got.dtype == x.dtype
    # both accumulate in the feature dtype; bf16 sums of up to n*k terms
    # may round in another order
    tol = 0 if dtype == "float32" else 4e-2
    np.testing.assert_allclose(np.asarray(dx_got, np.float32),
                               np.asarray(dx_want, np.float32),
                               rtol=tol, atol=tol or 1e-6)
    # points no row picks get exactly zero
    unused = np.setdiff1d(np.arange(n), np.asarray(idx).ravel())
    assert not np.asarray(dx_got, np.float32)[:, unused].any()
