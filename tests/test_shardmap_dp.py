"""Explicit shard_map data parallelism vs the single-device run.

Under ``shard_map`` every BN takes an explicit ``axis_name`` and pmeans
its moments (cross-replica BN), the losses reduce globally, and the
per-shard gradients are reduced by the step.

These tests run the model's blocks on the 8-virtual-device CPU mesh, one
batch row per device, and assert agreement with the single-device run:
forward values, BN state, and ALL gradients (param grads psum'd, input
grads shard-local). Step-level tests do the same for the full shard_map
train/eval steps (train/steps.py) vs the plain jit steps.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from weaksuppointcloudseg_tpu import configs
from weaksuppointcloudseg_tpu.models import layers
from weaksuppointcloudseg_tpu.ops import neighbors as knn_ops
from weaksuppointcloudseg_tpu.parallel import make_mesh

AXIS = "data"
KW = dict(training=True, bn_decay=0.9)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8
    return make_mesh(8)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _mk_params(c_in, c_out, seed):
    r = np.random.default_rng(seed)
    gamma = r.standard_normal((c_out,)) * 0.3 + 1.0
    # negative-scale channels exercise the min-extremum selection path
    gamma = np.where(np.arange(c_out) % 3 == 0, -gamma, gamma)
    return {
        "w": jnp.asarray(r.standard_normal((c_in, c_out)) * 0.3, jnp.float32),
        "b": jnp.asarray(r.standard_normal((c_out,)) * 0.1, jnp.float32),
        "gamma": jnp.asarray(gamma, jnp.float32),
        "beta": jnp.asarray(r.standard_normal((c_out,)) * 0.1, jnp.float32),
    }


def _compare(single, sharded, *, atol=5e-5, rtol=1e-4):
    # atol floor: near-zero sums (dbeta = sum(dz) over ~2.5k random-sign
    # terms) move O(1e-5) under the psum's different reassociation
    """allclose over (loss, aux pytree, grads pytree) result triples."""
    flat_s, _ = jax.tree_util.tree_flatten(single)
    flat_m, _ = jax.tree_util.tree_flatten(sharded)
    assert len(flat_s) == len(flat_m)
    for i, (a, b) in enumerate(zip(flat_s, flat_m)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"leaf {i}")


def _run_block(mesh, local, p_args, sharded_args):
    """Run ``local(axis_name, *p_args, *sharded_args)`` single-device and
    under shard_map; return both results.

    ``local`` must return (scalar_loss, replicated_aux, (param_grads...,
    input_grad)) where input_grad is w.r.t. the FIRST sharded arg.
    """
    single = local(None, *p_args, *sharded_args)

    n_p, n_s = len(p_args), len(sharded_args)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=tuple([P()] * n_p + [P(AXIS)] * n_s),
        out_specs=(P(), P(), tuple([P()] * n_p + [P(AXIS)])),
        check_vma=False)
    def run(*args):
        loss, aux, grads = local(AXIS, *args)
        loss = jax.lax.psum(loss, AXIS)
        pgrads = tuple(jax.lax.psum(g, AXIS) for g in grads[:-1])
        return loss, aux, pgrads + (grads[-1],)

    return single, run(*p_args, *sharded_args)


@pytest.mark.parametrize("widths", [(16,), (16, 12)])
def test_edge_conv_stage_dp(mesh, rng, widths):
    """A whole plain EdgeConv stage (gather + first conv + BN + relu
    [+ second conv + BN + relu] + k-max) with cross-replica BN."""
    b, n, c, k = 8, 40, 6, 5
    f = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32)
    idx = jnp.asarray(knn_ops.knn_graph(f, k))
    R = jnp.asarray(rng.standard_normal((b, n, widths[-1])), jnp.float32)
    ps = tuple(_mk_params(ci, co, 7 + i) for i, (ci, co) in
               enumerate(zip((2 * c,) + widths[:-1], widths)))

    def local(axis_name, ps, f, idx, R):
        def loss_fn(ps, f):
            kw = dict(axis_name=axis_name, **KW)
            st = {"mean": jnp.zeros((widths[0],)),
                  "var": jnp.ones((widths[0],))}
            h, ns = layers.apply_edge_conv(
                ps[0], st, f, knn_ops.gather_neighbors(f, idx), **kw)
            states = [ns]
            for p_i, w in zip(ps[1:], widths[1:]):
                st = {"mean": jnp.zeros((w,)), "var": jnp.ones((w,))}
                h, ns = layers.apply_conv(p_i, st, h, **kw)
                states.append(ns)
            return jnp.sum(jnp.max(h, axis=2) * R), states
        (l, aux), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(ps, f)
        return l, aux, grads

    single, sharded = _run_block(mesh, local, (ps,), (f, idx, R))
    _compare(single, sharded)


def test_xla_bn_conv_dp(mesh, rng):
    """The plain XLA conv+BN path (axis_name -> lax.pmean of moments)."""
    b, n, c, c2 = 8, 40, 12, 16
    h = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32)
    R = jnp.asarray(rng.standard_normal((b, n, c2)), jnp.float32)
    p = _mk_params(c, c2, 6)
    st = {"mean": jnp.zeros((c2,)), "var": jnp.ones((c2,))}

    def local(axis_name, p, h, R):
        def loss_fn(p, h):
            out, ns = layers.apply_conv(p, st, h, axis_name=axis_name, **KW)
            return jnp.sum(out * R), ns
        (l, aux), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(p, h)
        return l, aux, grads

    single, sharded = _run_block(mesh, local, (p,), (h, R))
    _compare(single, sharded)


def test_shardmap_train_step_matches_jit_step(mesh):
    """Full-style shard_map train step == single-device jit step: every
    loss component, accuracy, and the updated params (dropout disabled —
    the shard_map step decorrelates dropout keys per shard by design)."""
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.train.steps import make_train_step

    base = configs.shapenet_config()
    model = dataclasses.replace(
        base.model, num_points=64, num_classes=12, num_categories=4,
        k=8, global_channels=64, edge_channels=((16, 16), (16,)),
        head_channels=(32, 16), head_keep_prob=(None, None),
    )
    train = dataclasses.replace(base.train, batch_size=8, style="Full")
    weaksup = dataclasses.replace(base.weaksup, smooth_knn=4)
    cfg = dataclasses.replace(base, model=model, train=train,
                              weaksup=weaksup)

    r = np.random.default_rng(7)
    B, N, K, C = 16, 64, 12, 3  # 16 rows = 8 Siamese pairs, 2 rows/device
    seg = r.integers(0, K, (B, N))
    batch = {
        "data": r.standard_normal((B, N, C)).astype(np.float32),
        "seg": seg.astype(np.int32),
        "seg_onehot": np.eye(K, dtype=np.float32)[seg],
        "mask": (r.random((B, N)) < 0.1).astype(np.float32),
        "cat_onehot": np.eye(4, dtype=np.float32)[r.integers(0, 4, (B,))],
        "valid": np.ones((B,), np.float32),
    }
    gate = np.float32(1.0)
    key = jax.random.PRNGKey(11)

    s1 = create_train_state(jax.random.PRNGKey(0), cfg)
    s8 = create_train_state(jax.random.PRNGKey(0), cfg)
    step1 = make_train_step(cfg)
    step8 = make_train_step(cfg, mesh=mesh)
    ns1, m1 = step1(s1, batch, gate, key)
    ns8, m8 = step8(s8, batch, gate, key)

    for k_ in sorted(m1):
        np.testing.assert_allclose(np.asarray(m1[k_]), np.asarray(m8[k_]),
                                   rtol=2e-4, atol=1e-6, err_msg=k_)

    # Gradient-level comparison (params after an Adam step are NOT a sound
    # pin: several leaves — conv biases under BN, agg_conv.beta — have
    # identically-zero true gradients, so both paths produce ~1e-7 noise
    # that Adam's first step amplifies to +-lr with arbitrary sign).
    # This also pins the check_vma=False psum-transpose semantics the
    # step's grad pmean relies on (see make_train_step).
    from weaksuppointcloudseg_tpu.train import steps as steps_mod

    state = create_train_state(jax.random.PRNGKey(0), cfg)

    def grads_fn(axis_name, params, bn_state, batch, rng):
        gf = jax.value_and_grad(steps_mod._loss_fn, has_aux=True)
        (loss, _), grads = gf(params, bn_state, batch, cfg=cfg,
                              style="Full", bn_decay=0.9, gate=gate,
                              rng=rng, axis_name=axis_name)
        return loss, grads

    l1, g1 = grads_fn(None, state.params, state.bn_state, batch, key)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P(), P(AXIS), P()),
                       out_specs=(P(), P()), check_vma=False)
    def sharded_grads(params, bn_state, batch, rng):
        l, g = grads_fn(AXIS, params, bn_state, batch, rng)
        return l, jax.lax.pmean(g, AXIS)

    l8, g8 = sharded_grads(state.params, state.bn_state, batch, key)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l8), rtol=1e-6)
    flat1 = jax.tree_util.tree_flatten_with_path(g1)[0]
    flat8 = jax.tree_util.tree_flatten(g8)[0]
    for (path, a), b in zip(flat1, flat8):
        a, b = np.asarray(a), np.asarray(b)
        if np.abs(a).max() < 1e-5:  # degenerate (true-zero) gradient leaf
            assert np.abs(b).max() < 1e-5, jax.tree_util.keystr(path)
            continue
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=5e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_shardmap_eval_step_matches_jit_step(mesh):
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.train.steps import make_eval_step

    base = configs.shapenet_config()
    model = dataclasses.replace(
        base.model, num_points=64, num_classes=12, num_categories=4,
        k=8, global_channels=64, edge_channels=((16, 16), (16,)),
        head_channels=(32, 16), head_keep_prob=(None, None),
    )
    cfg = dataclasses.replace(base, model=model)

    r = np.random.default_rng(9)
    B, N, K = 8, 64, 12
    seg = r.integers(0, K, (B, N))
    batch = {
        "data": r.standard_normal((B, N, 3)).astype(np.float32),
        "seg_onehot": np.eye(K, dtype=np.float32)[seg],
        "mask": (r.random((B, N)) < 0.2).astype(np.float32),
        "cat_onehot": np.eye(4, dtype=np.float32)[r.integers(0, 4, (B,))],
    }
    state = create_train_state(jax.random.PRNGKey(0), cfg)
    prob1, loss1 = make_eval_step(cfg)(state, batch)
    prob8, loss8 = make_eval_step(cfg, mesh=mesh)(state, batch)
    np.testing.assert_allclose(np.asarray(loss1), np.asarray(loss8),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(prob1), np.asarray(prob8),
                               rtol=1e-4, atol=1e-6)


