"""Layer-level semantics: reference batch norm, conv init, dropout,
transform net identity init, model parameter inventory."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from weaksuppointcloudseg_tpu import configs
from weaksuppointcloudseg_tpu.models import layers
from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg
from weaksuppointcloudseg_tpu.models.transform_net import (
    init_transform_net,
    apply_transform_net,
)


class TestBatchNorm:
    """batch_norm_dist_template semantics (tf_util.py:502-535): training
    normalizes with *batch* moments (biased variance) and updates
    pop = pop * decay + batch * (1 - decay); eval uses pop stats."""

    def setup_method(self):
        self.params = {
            "beta": jnp.asarray([1.0, -1.0]),
            "gamma": jnp.asarray([2.0, 0.5]),
        }
        self.state = {"mean": jnp.asarray([0.1, 0.2]),
                      "var": jnp.asarray([1.5, 0.5])}

    def test_training_uses_batch_moments(self, rng):
        x = jnp.asarray(rng.standard_normal((4, 8, 2)) * 3 + 1, jnp.float32)
        y, new_state = layers._batch_norm(
            x, self.params, self.state, training=True, decay=0.9, eps=1e-3)
        x_np = np.asarray(x)
        mean = x_np.reshape(-1, 2).mean(0)
        var = x_np.reshape(-1, 2).var(0)  # biased, like tf.nn.moments
        want = ((x_np - mean) / np.sqrt(var + 1e-3)) * np.asarray(
            self.params["gamma"]) + np.asarray(self.params["beta"])
        np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-5)
        # pop-stat update rule
        np.testing.assert_allclose(
            np.asarray(new_state["mean"]),
            np.asarray(self.state["mean"]) * 0.9 + mean * 0.1, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(new_state["var"]),
            np.asarray(self.state["var"]) * 0.9 + var * 0.1, rtol=1e-5)

    def test_eval_uses_population_stats(self, rng):
        x = jnp.asarray(rng.standard_normal((4, 8, 2)), jnp.float32)
        y, new_state = layers._batch_norm(
            x, self.params, self.state, training=False, decay=0.9, eps=1e-3)
        want = ((np.asarray(x) - np.asarray(self.state["mean"]))
                / np.sqrt(np.asarray(self.state["var"]) + 1e-3)
                ) * np.asarray(self.params["gamma"]) + np.asarray(self.params["beta"])
        np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-5)
        assert new_state is self.state  # untouched at eval


class TestConvDropout:
    def test_xavier_range(self):
        p, _ = layers.init_conv(jax.random.PRNGKey(0), 64, 128)
        limit = np.sqrt(6.0 / (64 + 128))
        w = np.asarray(p["w"])
        assert w.shape == (64, 128)
        assert np.abs(w).max() <= limit + 1e-6
        assert w.std() > limit / 4  # actually spread out, not zeros

    def test_conv_no_bn_no_relu_is_affine(self, rng):
        p, _ = layers.init_conv(jax.random.PRNGKey(0), 4, 3, bn=False)
        x = jnp.asarray(rng.standard_normal((2, 5, 4)), jnp.float32)
        y, _ = layers.apply_conv(p, {}, x, training=True, bn=False, relu=False)
        want = np.asarray(x) @ np.asarray(p["w"]) + np.asarray(p["b"])
        np.testing.assert_allclose(np.asarray(y), want, rtol=1e-5, atol=1e-6)

    def test_dropout_inverted_scaling(self, rng):
        x = jnp.ones((1000, 8))
        y = layers.dropout(x, jax.random.PRNGKey(1), 0.6, training=True)
        y_np = np.asarray(y)
        kept = y_np != 0
        # kept values scaled by 1/keep_prob
        np.testing.assert_allclose(y_np[kept], 1 / 0.6, rtol=1e-5)
        assert kept.mean() == pytest.approx(0.6, abs=0.05)
        # eval: identity
        np.testing.assert_array_equal(
            np.asarray(layers.dropout(x, jax.random.PRNGKey(1), 0.6,
                                      training=False)), np.asarray(x))


class TestTransformNet:
    def test_identity_at_init(self, rng):
        """Zero weights + identity bias -> the initial transform is I
        (transform_nets.py:42-51), regardless of input."""
        params, state = init_transform_net(jax.random.PRNGKey(0), in_c=6, K=3)
        ef = jnp.asarray(rng.standard_normal((2, 32, 4, 6)), jnp.float32)
        t, _ = apply_transform_net(params, state, ef, K=3,
                                   training=False, bn_decay=None)
        np.testing.assert_allclose(
            np.asarray(t), np.tile(np.eye(3), (2, 1, 1)), atol=1e-5)


class TestModelInventory:
    def test_shapenet_param_shapes(self):
        """Layer widths match DGCNN_ShapeNet.py:15-113."""
        cfg = configs.shapenet_config().model
        params, state = init_dgcnn_seg(jax.random.PRNGKey(0), cfg)
        w = {k: tuple(v["w"].shape) for k, v in params.items() if "w" in v}
        assert w["adj_conv1"] == (6, 64)     # edge features of xyz
        assert w["adj_conv2"] == (64, 64)
        assert w["adj_conv3"] == (128, 64)   # edge features of 64-d stage
        assert w["adj_conv4"] == (64, 64)
        assert w["adj_conv5"] == (128, 64)
        # aggregation concatenates the 3 stage outputs net_1/2/3 (64 each),
        # DGCNN_ShapeNet.py:80
        assert w["agg_conv"] == (64 * 3, 1024)
        assert w["cat_embed"] == (16, 64)
        # seg head input: global(1024) + category(64) + net_1/2/3 (192)
        assert w["seg_conv1"] == (1024 + 64 + 64 * 3, 256)
        assert w["seg_conv2"] == (256, 256)
        assert w["seg_conv3"] == (256, 128)
        assert w["seg_out"] == (128, 50)
        assert tuple(params["transform_net"]["transform_out"]["w"].shape) == (256, 9)

    def test_s3dis_param_shapes(self):
        """Layer widths match DGCNN_S3DIS.py:24-104."""
        cfg = configs.s3dis_config().model
        params, _ = init_dgcnn_seg(jax.random.PRNGKey(0), cfg)
        w = {k: tuple(v["w"].shape) for k, v in params.items() if "w" in v}
        assert w["adj_conv1"] == (18, 64)    # 9-channel input edge features
        assert w["agg_conv"] == (64 * 3, 1024)
        assert w["seg_conv1"] == (1024 + 64 * 3, 512)
        assert w["seg_conv2"] == (512, 256)
        assert w["seg_out"] == (256, 13)
        assert "transform_net" not in params
        assert "cat_embed" not in params

    def test_s3dis_unnorm_xyz_graph_variant(self):
        """The reference's dormant get_model_unnormXYZ (DGCNN_S3DIS.py:
        106-186 — kNN graph on the RAW xyz channels 0:3 instead of the
        normalized 6:9; defined but never called) is this framework's
        s3dis preset with knn_channels=(0, 3). The graph choice must
        actually change the output."""
        from weaksuppointcloudseg_tpu.models.dgcnn import apply_dgcnn_seg

        base = configs.s3dis_config().model
        base = dataclasses.replace(
            base, num_points=32, edge_channels=((8, 8), (8, 8), (8,)),
            global_channels=16, head_channels=(16, 8), k=4)
        un = dataclasses.replace(base, knn_channels=(0, 3))
        params, state = init_dgcnn_seg(jax.random.PRNGKey(0), base)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((2, 32, 9)), jnp.float32)
        y_norm, _ = apply_dgcnn_seg(params, state, x, None, cfg=base,
                                    training=False, bn_decay=None)
        y_raw, _ = apply_dgcnn_seg(params, state, x, None, cfg=un,
                                   training=False, bn_decay=None)
        assert y_raw.shape == y_norm.shape == (2, 32, 13)
        assert not np.allclose(np.asarray(y_raw), np.asarray(y_norm))


class TestEdgeConvDecomposition:
    def test_matches_conv_of_edge_features(self, rng):
        """u_i + v_j decomposition == conv(concat([f_i, f_j - f_i]))."""
        import weaksuppointcloudseg_tpu.ops.neighbors as knn_ops

        b, n, c, k, c_out = 2, 64, 8, 5, 16
        params, state = layers.init_conv(jax.random.PRNGKey(0), 2 * c, c_out)
        f = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32)
        idx = knn_ops.knn_graph(f, k)

        ef = knn_ops.edge_feature(f, idx)
        want, want_state = layers.apply_conv(
            params, state, ef, training=True, bn_decay=0.9)
        got, got_state = layers.apply_edge_conv_first(
            params, state, f, idx, training=True, bn_decay=0.9)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
        for key in ("mean", "var"):
            np.testing.assert_allclose(np.asarray(got_state[key]),
                                       np.asarray(want_state[key]),
                                       rtol=1e-4, atol=1e-6)


class TestEdgeConvMatmul:
    """edge_conv_matmul: forward == straight concat+conv bit-for-bit;
    the d_ef-free custom VJP matches the mechanical transpose."""

    def test_forward_and_grads_match_straight_path(self, rng):
        b, n, k, c, co = 2, 32, 6, 5, 8
        f = jnp.asarray(rng.standard_normal((b, n, c)), jnp.float32)
        nbr = jnp.asarray(rng.standard_normal((b, n, k, c)), jnp.float32)
        w = jnp.asarray(rng.standard_normal((2 * c, co)), jnp.float32)
        bias = jnp.asarray(rng.standard_normal((co,)), jnp.float32)

        def straight(f, nbr, w, bias):
            ef = jnp.concatenate(
                [jnp.broadcast_to(f[:, :, None, :], nbr.shape),
                 nbr - f[:, :, None, :]], axis=-1)
            return jnp.einsum("...i,io->...o", ef, w) + bias

        y1 = layers.edge_conv_matmul(f, nbr, w, bias)
        y2 = straight(f, nbr, w, bias)
        np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))

        def loss_custom(args):
            return jnp.sum(jnp.sin(layers.edge_conv_matmul(*args)))

        def loss_straight(args):
            return jnp.sum(jnp.sin(straight(*args)))

        g1 = jax.grad(loss_custom)((f, nbr, w, bias))
        g2 = jax.grad(loss_straight)((f, nbr, w, bias))
        for a, b_ in zip(g1, g2):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                       rtol=2e-5, atol=2e-5)


def test_conv_bcast_matches_concat(rng):
    """apply_conv_bcast == conv over concat([tile(global), points]):
    values, BN state, and gradients (split-contraction reassociation
    only; db ~ 0 by BN shift invariance, hence the atol)."""
    import jax

    from weaksuppointcloudseg_tpu.models import layers

    B, N, Cg, Cp, C2 = 2, 40, 20, 12, 16
    g = jnp.asarray(rng.standard_normal((B, Cg)), jnp.float32)
    p = jnp.asarray(rng.standard_normal((B, N, Cp)), jnp.float32)
    params = {
        "w": jnp.asarray(rng.standard_normal((Cg + Cp, C2)) * 0.3,
                         jnp.float32),
        "b": jnp.asarray(rng.standard_normal((C2,)) * 0.1, jnp.float32),
        "gamma": jnp.ones((C2,)),
        "beta": jnp.zeros((C2,)),
    }
    st = {"mean": jnp.zeros((C2,)), "var": jnp.ones((C2,))}
    kw = dict(training=True, bn_decay=0.9)
    x = jnp.concatenate(
        [jnp.broadcast_to(g[:, None], (B, N, Cg)), p], -1)
    y1, s1 = layers.apply_conv_bcast(params, st, g, p, **kw)
    y2, s2 = layers.apply_conv(params, st, x, **kw)
    np.testing.assert_allclose(y1, y2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1["mean"], s2["mean"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(s1["var"], s2["var"], rtol=1e-5, atol=1e-7)

    def f1(params):
        return jnp.sum(layers.apply_conv_bcast(params, st, g, p, **kw)[0]
                       ** 2)

    def f2(params):
        return jnp.sum(layers.apply_conv(params, st, x, **kw)[0] ** 2)

    g1, g2 = jax.grad(f1)(params), jax.grad(f2)(params)
    for name in g1:
        np.testing.assert_allclose(g1[name], g2[name], rtol=1e-3,
                                   atol=5e-5, err_msg=name)


class TestStaticGraphModel:
    """ModelConfig.static_graph: runs train + eval,
    gradients flow to every parameter, and the reused graph equals the
    input-coordinate kNN (checked against a hand-driven composition of
    the same stages fed that one graph)."""

    def _setup(self, rng, use_transform):
        from weaksuppointcloudseg_tpu.models.dgcnn import (
            apply_dgcnn_seg,
            init_dgcnn_seg,
        )

        cfg = configs.shapenet_config().model if use_transform else (
            configs.s3dis_config().model)
        cfg = dataclasses.replace(cfg, static_graph=True, num_points=48)
        params, state = init_dgcnn_seg(jax.random.PRNGKey(0), cfg)
        if "transform_net" in params:
            # the reference zero-initializes transform_out.w, which blocks
            # all gradient into the transform branch at init — perturb it
            # so the grads-flow check is meaningful
            tn = dict(params["transform_net"])
            tn["transform_out"] = dict(
                tn["transform_out"],
                w=0.01 * jax.random.normal(
                    jax.random.PRNGKey(9),
                    tn["transform_out"]["w"].shape))
            params = dict(params, transform_net=tn)
        x = jnp.asarray(
            rng.standard_normal((2, 48, cfg.in_channels)), jnp.float32)
        cat = (jax.nn.one_hot(jnp.asarray([1, 7]), cfg.num_categories)
               if cfg.num_categories else None)
        return apply_dgcnn_seg, cfg, params, state, x, cat

    @pytest.mark.parametrize("use_transform", [True, False])
    def test_train_grads_flow_everywhere(self, rng, use_transform):
        apply_fn, cfg, params, state, x, cat = self._setup(
            rng, use_transform)

        def loss(p):
            logits, _ = apply_fn(p, state, x, cat, cfg=cfg, training=True,
                                 bn_decay=0.9, rng=jax.random.PRNGKey(3))
            return jnp.sum(logits ** 2) * 1e-4

        grads = jax.grad(loss)(params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            if "transform_out" in str(path):
                continue  # zero-init weights: gradient may legally be 0
            assert float(jnp.sum(jnp.abs(leaf))) > 0.0, path

        logits, _ = apply_fn(params, state, x, cat, cfg=cfg,
                             training=False, bn_decay=0.9)
        assert bool(jnp.all(jnp.isfinite(logits)))

    def test_static_graph_is_the_input_graph(self, rng, monkeypatch):
        """With static_graph (S3DIS preset), the ONLY kNN
        computation is the one on the input coordinates (channels 6:9),
        and every stage gathers along exactly that graph — verified by
        capturing the knn/gather call arguments. Also: the static model
        must diverge from the dynamic one (stages 2+ would otherwise
        re-select neighbors in feature space)."""
        import weaksuppointcloudseg_tpu.ops.neighbors as knn_ops

        apply_fn, cfg, params, state, x, cat = self._setup(rng, False)

        graphs, gathers = [], []
        real_nn = knn_ops.nearest_neighbors
        real_gather = knn_ops.gather_neighbors

        def spy_nn(g, k, **kw):
            idx = real_nn(g, k, **kw)
            graphs.append((np.asarray(g), np.asarray(idx)))
            return idx

        def spy_gather(f, idx):
            gathers.append(np.asarray(idx))
            return real_gather(f, idx)

        monkeypatch.setattr(knn_ops, "nearest_neighbors", spy_nn)
        monkeypatch.setattr(knn_ops, "gather_neighbors", spy_gather)

        logits_s, _ = apply_fn(params, state, x, cat, cfg=cfg,
                               training=False, bn_decay=0.9)
        # exactly ONE graph computation, on the input's kNN channels
        uniq = graphs
        assert len(uniq) == 1, f"{len(uniq)} distinct graphs built"
        g_src, idx = uniq[0]
        lo, hi = cfg.knn_channels
        np.testing.assert_array_equal(g_src, np.asarray(x)[..., lo:hi])
        # every stage gathered along exactly that graph
        assert len(gathers) == len(cfg.edge_channels)
        for gi in gathers:
            np.testing.assert_array_equal(gi, idx)

        monkeypatch.undo()
        cfg_dyn = dataclasses.replace(cfg, static_graph=False)
        logits_d, _ = apply_fn(params, state, x, cat, cfg=cfg_dyn,
                               training=False, bn_decay=0.9)
        # same weights, different graphs for stages 2+: outputs differ
        assert float(jnp.max(jnp.abs(logits_s - logits_d))) > 1e-6


def test_cls_static_graph_cpu(rng):
    """ClsConfig.static_graph: train grads flow + eval finite."""
    from weaksuppointcloudseg_tpu.models.dgcnn_cls import (
        ClsConfig,
        apply_dgcnn_cls,
        classification_loss,
        init_dgcnn_cls,
    )

    cfg = ClsConfig(static_graph=True)
    params, state = init_dgcnn_cls(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(rng.standard_normal((2, 48, 3)), jnp.float32)
    labels = jnp.asarray([3, 7])

    def loss(p):
        logits, _ = apply_dgcnn_cls(p, state, x, cfg=cfg, training=True,
                                    bn_decay=0.9, rng=jax.random.PRNGKey(2))
        return classification_loss(logits, labels)

    l, g = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(l))
    # every stage conv must receive gradient through the reused graph
    for i in range(len(cfg.edge_channels)):
        gi = g[f"dgcnn{i + 1}"]["w"]
        assert float(jnp.sum(jnp.abs(gi))) > 0.0, f"dgcnn{i + 1} dead"
    logits, _ = apply_dgcnn_cls(params, state, x, cfg=cfg, training=False,
                                bn_decay=0.9)
    assert bool(jnp.all(jnp.isfinite(logits)))
