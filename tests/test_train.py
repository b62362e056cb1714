"""End-to-end training-loop tests on synthetic data (SURVEY.md §4 items 4-5).

Tiny shapes keep CPU compiles fast: 64-point clouds, 2-sample batches.
"""

import dataclasses

import numpy as np
import jax
import pytest

from weaksuppointcloudseg_tpu import configs
from weaksuppointcloudseg_tpu.data import shapenet, s3dis, sampling
from weaksuppointcloudseg_tpu.train.loop import ShapeNetTrainer, S3DISTrainer


def tiny_shapenet_cfg(style="Plain", batch_size=2):
    base = configs.shapenet_config()
    model = dataclasses.replace(
        base.model, num_points=64, num_classes=12, num_categories=4,
        k=8, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)),
        head_channels=(32, 32, 16),
        head_keep_prob=(0.6, 0.6, None),
    )
    train = dataclasses.replace(
        base.train, batch_size=batch_size, style=style, epochs=2, rampup=1
    )
    weaksup = dataclasses.replace(base.weaksup, smooth_knn=4, rampup=1)
    return dataclasses.replace(base, model=model, train=train, weaksup=weaksup)


def tiny_s3dis_cfg(style="Plain", batch_size=2):
    base = configs.s3dis_config()
    model = dataclasses.replace(
        base.model, num_points=64, k=8, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)),
        head_channels=(32, 16),
        head_keep_prob=(None, 0.7),
    )
    train = dataclasses.replace(
        base.train, batch_size=batch_size, style=style, epochs=2, rampup=1
    )
    weaksup = dataclasses.replace(base.weaksup, smooth_knn=4, rampup=1)
    return dataclasses.replace(base, model=model, train=train, weaksup=weaksup)


@pytest.fixture(scope="module")
def shapenet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sn")
    shapenet.write_synthetic(str(d), num_points=64, train_samples=16,
                             val_samples=4, test_samples=2)
    return str(d)


@pytest.fixture(scope="module")
def s3dis_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("s3")
    s3dis.write_synthetic(str(d), num_points=64)
    return str(d)


class TestShapeNetTraining:
    def test_plain_loss_decreases(self, shapenet_dir):
        cfg = tiny_shapenet_cfg("Plain")
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        pts_idx = sampling.generate_sample_index(ds.num_samples("train"), 64, 0.2)
        tr = ShapeNetTrainer(cfg, ds, pts_idx, seed=0)
        first = tr.train_epoch()
        for _ in range(5):
            last = tr.train_epoch()
        assert last["seg"] < first["seg"]
        assert tr.epoch == 6

    def test_eval_quality_after_training(self, tmp_path):
        """Population-BN-stats eval must track training quality: train the
        tiny model until train acc is high, then assert the trainer's
        evaluate() (training=False forward — population stats, no dropout)
        scores well on the val split. Guards the whole moving-stats +
        eval-forward path — a regression there leaves every train-time
        metric healthy while eval silently returns ~chance (exactly how
        the round-3 convergence-test val-data bug stayed hidden)."""
        cfg = tiny_shapenet_cfg("Plain", batch_size=4)
        d = str(tmp_path / "sn_eval")
        shapenet.write_synthetic(d, num_points=64, train_samples=32,
                                 val_samples=16, test_samples=2, seed=0)
        ds = shapenet.ShapeNetDataset(d)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0)
        for _ in range(30):
            m = tr.train_epoch()
        assert m["acc"] > 0.55, f"undertrained: {m}"
        loss, acc, perdata, pershape = tr.evaluate()
        assert acc > 0.5, f"population-stats eval acc collapsed: {acc}"
        assert float(np.mean(pershape)) > 0.35, (
            f"eval mIoU collapsed: {float(np.mean(pershape))}")

    def test_threefry_rng_impl_compat(self, shapenet_dir):
        """The bit-reproducibility opt-out (configs.py TrainConfig.rng_impl
        = "threefry2x32") still trains: the default per-step stream is
        "rbg" (XLA's RngBitGenerator, cheaper than threefry)."""
        cfg = tiny_shapenet_cfg("Plain")
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           rng_impl="threefry2x32"))
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0)
        m = tr.train_epoch()
        assert np.isfinite(m["total"])

    def test_full_style_components_and_gate(self, shapenet_dir):
        cfg = tiny_shapenet_cfg("Full")
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        pts_idx = sampling.generate_sample_index(ds.num_samples("train"), 64, 0.2)
        tr = ShapeNetTrainer(cfg, ds, pts_idx, seed=0)
        # epoch 0 < rampup=1: gate off -> total == seg
        m0 = tr.train_epoch()
        assert m0["total"] == pytest.approx(m0["seg"], rel=1e-5)
        # epoch 1 >= rampup: gate on, weak components contribute
        m1 = tr.train_epoch()
        assert m1["total"] > m1["seg"]
        for k in ("siamese", "inexact", "smooth"):
            assert m1[k] >= 0

    def test_eval_and_test(self, shapenet_dir):
        cfg = tiny_shapenet_cfg("Plain")
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0)
        loss, acc, perdata, pershape = tr.evaluate()
        assert 0 <= acc <= 1 and 0 <= perdata <= 1
        assert pershape.shape == (4,)
        ts = shapenet.ShapeNetTestSet(shapenet_dir)
        res = tr.test(ts, num_points=96, use_label_prop=True)
        assert 0 <= res["perdata_miou"] <= 1
        assert 0 <= res["accuracy"] <= 1

    def test_cover_partition_covers_every_point(self):
        rng = np.random.default_rng(0)
        for n, target in ((40, 64), (64, 64), (150, 64), (129, 64)):
            views = shapenet.cover_partition(n, target, rng)
            assert all(len(v) == target for v in views)
            assert len(views) == max(1, -(-n // target))
            covered = np.unique(np.concatenate(views))
            np.testing.assert_array_equal(covered, np.arange(n))
            if n <= target:  # original points first (reference slice trick)
                np.testing.assert_array_equal(views[0][:n], np.arange(n))

    def test_large_shapes_fully_scored(self, shapenet_dir):
        """Shapes with more points than the inference size (quirk Q3 —
        crashes the reference) are split into covering views and every
        original point is scored."""
        cfg = tiny_shapenet_cfg("Plain")
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0)
        ts = shapenet.ShapeNetTestSet(shapenet_dir)
        assert any(len(ts[i][0]) > 32 for i in range(len(ts)))
        res = tr.test(ts, num_points=32, use_label_prop=True)
        assert 0 <= res["perdata_miou"] <= 1
        assert 0 <= res["accuracy"] <= 1

    def test_eval_loss_unbiased_by_tail_padding(self, shapenet_dir):
        """The padded tail batch must not bias the validation loss: a batch
        size that divides the val set and one that leaves a ragged tail
        must produce the same (valid-weighted) loss."""
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr4 = ShapeNetTrainer(tiny_shapenet_cfg("Plain", batch_size=4),
                              ds, None, seed=0)
        tr3 = ShapeNetTrainer(tiny_shapenet_cfg("Plain", batch_size=3),
                              ds, None, seed=0)
        loss4 = tr4.evaluate()[0]  # 4 val samples: one exact batch
        loss3 = tr3.evaluate()[0]  # batches of 3 + ragged tail of 1
        assert loss4 == pytest.approx(loss3, rel=1e-5)

    def test_checkpoint_roundtrip(self, shapenet_dir, tmp_path):
        cfg = tiny_shapenet_cfg("Plain")
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0, ckpt_dir=str(tmp_path))
        tr.train_epoch()
        tr.save_checkpoint(metric=0.5)
        step_before = int(tr.state.step)
        tr2 = ShapeNetTrainer(cfg, ds, None, seed=7, ckpt_dir=str(tmp_path))
        tr2.restore_checkpoint(tr.ckpt.best_path())
        assert int(tr2.state.step) == step_before
        assert tr2.epoch == tr.epoch
        p1 = jax.tree_util.tree_leaves(tr.state.params)
        p2 = jax.tree_util.tree_leaves(tr2.state.params)
        for a, b in zip(p1, p2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestS3DISTraining:
    def test_plain_runs_and_learns(self, s3dis_dir):
        cfg = tiny_s3dis_cfg("Plain")
        ds = s3dis.S3DISDataset(s3dis_dir)
        tr = S3DISTrainer(cfg, ds, None, test_area=5, seed=0)
        first = tr.train_epoch()
        for _ in range(5):
            last = tr.train_epoch()
        assert last["seg"] < first["seg"]

    def test_full_with_one_point_per_class(self, s3dis_dir):
        cfg = tiny_s3dis_cfg("Full")
        ds = s3dis.S3DISDataset(s3dis_dir)
        pts_idx = sampling.generate_one_point_per_class(ds.label)
        tr = S3DISTrainer(cfg, ds, pts_idx, test_area=5, seed=0)
        m = tr.train_epoch()
        assert np.isfinite(m["total"])

    def test_eval_and_room_test(self, s3dis_dir, tmp_path):
        cfg = tiny_s3dis_cfg("Plain")
        ds = s3dis.S3DISDataset(s3dis_dir)
        tr = S3DISTrainer(cfg, ds, None, test_area=5, seed=0)
        loss, acc, miou, per_class = tr.evaluate()
        assert per_class.shape == (13,)
        rooms = s3dis.S3DISTestRooms(s3dis_dir, "area5", num_point=64)
        res = tr.test(rooms, use_label_prop=True, pred_dir=str(tmp_path / "pred"))
        assert 0 <= res["miou"] <= 1
        # .mat room dumps written
        import os
        mats = [f for f in os.listdir(tmp_path / "pred") if f.endswith("_pred_gt.mat")]
        assert len(mats) == 2

    def test_room_lp_matches_dense_oracle(self, s3dis_dir):
        """room_label_prop (matfree CG over the whole room, blocks padded
        to a multiple of 8 with far-away points) must reproduce a dense-LU
        label propagation over the same unpadded concatenated cloud —
        proving both the CG solve and the pad-innocuity claim."""
        cfg = tiny_s3dis_cfg("Full")
        ds = s3dis.S3DISDataset(s3dis_dir)
        tr = S3DISTrainer(cfg, ds, None, test_area=5, seed=0)
        rooms = s3dis.S3DISTestRooms(s3dis_dir, "area5", num_point=64)
        blocks, labels, _, room_max = rooms.load_room(
            0, rng=np.random.default_rng(0))
        k, n = labels.shape
        assert k % 8 != 0  # the pad path must actually be exercised
        rng = np.random.default_rng(1)
        logits = rng.standard_normal((k, n, 13)).astype(np.float32) * 2
        prob = np.exp(logits)
        prob /= prob.sum(-1, keepdims=True)

        got = tr.room_label_prop(blocks, prob, room_max)
        assert got.shape == (k, n)

        from weaksuppointcloudseg_tpu.propagate import propagate_batch

        lp = cfg.labelprop
        xyz = (blocks[:, :, 6:9] * room_max).reshape(1, -1, 3).astype(np.float32)
        rgb = blocks[:, :, 3:6].reshape(1, -1, 3).astype(np.float32)
        want = np.asarray(propagate_batch(
            xyz, prob.reshape(1, -1, 13), rgb,
            alpha=lp.alpha, beta=lp.beta, xyz_bandwidth=lp.xyz_bandwidth,
            rgb_bandwidth=lp.rgb_bandwidth, ridge=lp.ridge,
            solver="solve", cg_iters=lp.cg_iters))
        want_pred = want[0].argmax(-1).reshape(k, n)
        assert (got == want_pred).mean() > 0.98

    def test_room_lp_end_to_end(self, s3dis_dir):
        """--RoomLP flow: forward + one room-level LP per room."""
        cfg = tiny_s3dis_cfg("Full")
        ds = s3dis.S3DISDataset(s3dis_dir)
        tr = S3DISTrainer(cfg, ds, None, test_area=5, seed=0)
        rooms = s3dis.S3DISTestRooms(s3dis_dir, "area5", num_point=64)
        res = tr.test(rooms, use_label_prop=True, room_lp=True)
        assert 0 <= res["miou"] <= 1
        assert res["per_class_iou"].shape == (13,)


class TestDataParallel:
    def test_mesh_training_matches_shapes(self, shapenet_dir):
        """Full 8-virtual-device data-parallel path compiles and runs."""
        assert jax.device_count() == 8
        cfg = tiny_shapenet_cfg("Plain", batch_size=8)
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0, num_devices=8)
        m = tr.train_epoch()
        assert np.isfinite(m["seg"])

    def test_mesh_full_style_pairs_local(self, shapenet_dir):
        cfg = tiny_shapenet_cfg("Full", batch_size=8)  # 16 rows over 8 devices
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr = ShapeNetTrainer(cfg, ds, None, seed=0, num_devices=8)
        m = tr.train_epoch()
        assert np.isfinite(m["total"])

    def test_dp_matches_single_device(self, shapenet_dir):
        """Same data, same seed: 8-device DP metrics == single-device metrics
        (cross-replica BN + psum grads must reproduce global-batch math)."""
        cfg = tiny_shapenet_cfg("Plain", batch_size=8)
        ds = shapenet.ShapeNetDataset(shapenet_dir)
        tr1 = ShapeNetTrainer(cfg, ds, None, seed=3)
        tr8 = ShapeNetTrainer(cfg, ds, None, seed=3, num_devices=8)
        m1 = tr1.train_epoch()
        m8 = tr8.train_epoch()
        assert m1["seg"] == pytest.approx(m8["seg"], rel=2e-3)
        assert m1["acc"] == pytest.approx(m8["acc"], rel=2e-3)

    def test_s3dis_mesh_training(self, s3dis_dir):
        """S3DIS Full-style step over the 8-device mesh."""
        cfg = tiny_s3dis_cfg("Full", batch_size=8)  # 16 rows over 8 devices
        ds = s3dis.S3DISDataset(s3dis_dir)
        tr = S3DISTrainer(cfg, ds, None, test_area=5, seed=0, num_devices=8)
        m = tr.train_epoch()
        assert np.isfinite(m["total"])


def test_make_eval_logits_fn_single_composition():
    """make_eval_logits_fn is the ONE eval composition: make_eval_step and
    both trainers' test loops route through it. It must equal the plain
    forward exactly — and accept both the cat-conditioned (ShapeNet) and
    plain (S3DIS) call shapes the trainers use."""
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.train.steps import (
        make_eval_logits_fn, make_forward_fn)
    from weaksuppointcloudseg_tpu.utils.tools import onehot_encode

    rng = np.random.default_rng(3)
    cfg = tiny_shapenet_cfg("Plain", batch_size=2)
    state = create_train_state(jax.random.PRNGKey(0), cfg)
    x = rng.standard_normal((2, 50, 3)).astype(np.float32)
    cat = onehot_encode(np.array([1, 2]), cfg.model.num_categories)
    logits = make_eval_logits_fn(cfg)(state, x, cat)
    want, _ = make_forward_fn(cfg)(
        state.params, state.bn_state, x, cat, training=False,
        bn_decay=None, rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(logits), np.asarray(want))

    s_cfg = tiny_s3dis_cfg("Plain", batch_size=2)
    s_state = create_train_state(jax.random.PRNGKey(1), s_cfg)
    xs = rng.standard_normal((2, 50, 9)).astype(np.float32)
    ls = jax.jit(make_eval_logits_fn(s_cfg))(s_state, xs)  # S3DIS call shape
    assert np.asarray(ls).shape == (2, 50, s_cfg.model.num_classes)


def test_convergence_recipe_eval_tail_smoke():
    """CPU smoke for the round-5 convergence-recipe knobs
    (utils/synth_convergence.py): the decoupled draw + tail-averaged
    eval path runs end-to-end at a tiny shape, and the coupled-mode
    misuse (eval_tail without data_seed) raises instead of silently
    perturbing the training rng stream. The calibrated 1024-pt recipe
    itself runs through scripts/convergence_ab.py."""
    import pytest

    from weaksuppointcloudseg_tpu.utils.synth_convergence import (
        shapenet_train_and_eval_miou,
    )

    m = shapenet_train_and_eval_miou(
        "float32", seed=0, epochs=2, data_seed=0, eval_tail=2,
        n_points=128, bs=4)
    assert 0.0 <= m <= 1.0
    with pytest.raises(ValueError, match="data_seed"):
        shapenet_train_and_eval_miou(
            "float32", seed=0, epochs=2, eval_tail=2,
            n_points=128, bs=4)
