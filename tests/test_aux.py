"""Aux subsystems: prefetch, profiling/metrics, provider augmentations,
DGCNN classifier, raw-S3DIS collection."""

import json
import os
import threading

import numpy as np
import jax
import pytest

from weaksuppointcloudseg_tpu.data import augment, indoor3d
from weaksuppointcloudseg_tpu.data.prefetch import prefetch
from weaksuppointcloudseg_tpu.models import dgcnn_cls
from weaksuppointcloudseg_tpu.utils.profiling import MetricsLogger, StepTimer, nan_debug


class TestPrefetch:
    def test_order_and_completeness(self):
        assert list(prefetch(range(17), depth=3)) == list(range(17))

    def test_transform_runs_on_producer_thread(self):
        main = threading.get_ident()
        seen = []

        def tf(x):
            seen.append(threading.get_ident())
            return x * 2

        out = list(prefetch(range(5), transform=tf))
        assert out == [0, 2, 4, 6, 8]
        assert all(t != main for t in seen)

    def test_producer_exception_propagates(self):
        def gen():
            yield 1
            raise RuntimeError("boom")

        it = prefetch(gen())
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="boom"):
            list(it)


class TestProfiling:
    def test_step_timer(self):
        t = StepTimer(ema=0.5)
        t.start()
        dt = t.stop(points=100)
        assert dt >= 0 and t.avg_step_s is not None
        assert t.points_per_sec > 0

    def test_metrics_logger(self, tmp_path):
        path = str(tmp_path / "metrics.jsonl")
        m = MetricsLogger(path)
        m.log("train_step", loss=np.float32(1.5), step=3)
        m.log("eval", miou=0.42)
        lines = [json.loads(l) for l in open(path)]
        assert lines[0]["event"] == "train_step"
        assert lines[0]["loss"] == pytest.approx(1.5)
        assert lines[1]["miou"] == pytest.approx(0.42)

    def test_nan_debug_toggles(self):
        with nan_debug(True):
            assert jax.config.jax_debug_nans
        assert not jax.config.jax_debug_nans


class TestProviderAugment:
    def test_rotation_preserves_norms(self, rng):
        x = rng.standard_normal((4, 64, 3)).astype(np.float32)
        r = augment.rotate_point_cloud(x, rng)
        np.testing.assert_allclose(
            np.linalg.norm(r, axis=-1), np.linalg.norm(x, axis=-1), rtol=1e-4
        )
        # y coordinate unchanged by y-axis rotation
        np.testing.assert_allclose(r[..., 1], x[..., 1], atol=1e-6)

    def test_rotate_by_angle_2pi_identity(self, rng):
        x = rng.standard_normal((2, 32, 3)).astype(np.float32)
        r = augment.rotate_point_cloud_by_angle(x, 2 * np.pi)
        np.testing.assert_allclose(r, x, atol=1e-5)

    def test_jitter_clip(self, rng):
        x = np.zeros((2, 128, 3), np.float32)
        j = augment.jitter_point_cloud(x, rng, sigma=1.0, clip=0.05)
        assert np.abs(j).max() <= 0.05 + 1e-6

    def test_scale_shift_shapes(self, rng):
        x = rng.standard_normal((3, 16, 3)).astype(np.float32)
        assert augment.shift_point_cloud(x, rng).shape == x.shape
        assert augment.random_scale_point_cloud(x, rng).shape == x.shape
        assert augment.rotate_perturbation_point_cloud(x, rng).shape == x.shape

    def test_shuffle_coherent(self, rng):
        x = np.arange(10)[:, None, None] * np.ones((10, 4, 3))
        y = np.arange(10)
        xs, ys, perm = augment.shuffle_data(x, y, rng)
        np.testing.assert_array_equal(xs[:, 0, 0], ys)


class TestClassifier:
    def test_forward_and_loss(self, rng):
        cfg = dgcnn_cls.ClsConfig(
            num_classes=10, k=4, edge_channels=(8, 8, 8, 16),
            global_channels=32, fc_channels=(16, 8),
        )
        params, state = dgcnn_cls.init_dgcnn_cls(jax.random.PRNGKey(0), cfg)
        x = rng.standard_normal((2, 32, 3)).astype(np.float32)
        logits, new_state = dgcnn_cls.apply_dgcnn_cls(
            params, state, x, cfg=cfg, training=True, bn_decay=0.9,
            rng=jax.random.PRNGKey(1),
        )
        assert logits.shape == (2, 10)
        labels = np.array([1, 7])
        loss = dgcnn_cls.classification_loss(logits, labels, 0.2)
        assert np.isfinite(float(loss))
        # smoothing=0 equals plain CE
        loss0 = dgcnn_cls.classification_loss(logits, labels, 0.0)
        log_p = jax.nn.log_softmax(logits, -1)
        want = -np.mean([log_p[i, l] for i, l in enumerate(labels)])
        assert float(loss0) == pytest.approx(float(want), rel=1e-5)


class TestIndoor3D:
    def test_collect_point_label(self, tmp_path, rng):
        anno = tmp_path / "Area_1" / "office_1" / "Annotations"
        anno.mkdir(parents=True)
        pts_chair = np.concatenate(
            [rng.uniform(0, 1, (50, 3)) + 5, rng.uniform(0, 255, (50, 3))], 1)
        pts_weird = np.concatenate(
            [rng.uniform(0, 1, (30, 3)), rng.uniform(0, 255, (30, 3))], 1)
        np.savetxt(anno / "chair_1.txt", pts_chair)
        np.savetxt(anno / "staris_1.txt", pts_weird)  # unknown -> clutter
        out = tmp_path / "room.npy"
        data = indoor3d.collect_point_label(str(anno), str(out), "numpy")
        assert data.shape == (80, 7)
        # shifted to origin
        assert data[:, 0:3].min(axis=0) == pytest.approx([0, 0, 0], abs=1e-9)
        labels = set(data[:, 6].astype(int))
        assert labels == {indoor3d.CLASS2LABEL["chair"],
                          indoor3d.CLASS2LABEL["clutter"]}

    def test_collect_tree_and_meta(self, tmp_path, rng):
        for area, room in [(1, "office_1"), (5, "hall_2")]:
            anno = tmp_path / "raw" / f"Area_{area}" / room / "Annotations"
            anno.mkdir(parents=True)
            pts = np.concatenate(
                [rng.uniform(0, 2, (40, 3)), rng.uniform(0, 255, (40, 3))], 1)
            np.savetxt(anno / "floor_1.txt", pts)
        out_dir = tmp_path / "stanford_indoor3d"
        written = indoor3d.collect_indoor3d_data(str(tmp_path / "raw"), str(out_dir))
        assert sorted(os.path.basename(w) for w in written) == [
            "Area_1_office_1.npy", "Area_5_hall_2.npy"]
        meta = indoor3d.write_area_meta(str(out_dir), str(tmp_path / "meta"), 5)
        rows = open(meta).read().split()
        assert rows == ["stanford_indoor3d/Area_5_hall_2.npy"]


class TestSiamesePairs:
    def test_s3dis_pairs_differ_post_rampup(self, rng):
        """Quirk Q11: the reference's in-place S3DIS augmentation makes both
        pair elements identical; ours must produce (original, augmented)."""
        from weaksuppointcloudseg_tpu.data import augment

        data = rng.standard_normal((3, 32, 9)).astype(np.float32)
        out = augment.make_siamese_batch(data, rng, augment.s3dis_augment)
        np.testing.assert_array_equal(out[0::2], data)  # originals untouched
        assert any(
            not np.array_equal(out[2 * i], out[2 * i + 1]) for i in range(3)
        )


class TestCheckpointFormat:
    """Format v2: key paths stored in the npz and verified on restore
    (silent positional mispairing of same-shaped leaves is impossible)."""

    def _tree(self):
        return {
            "params": {"conv1": {"w": np.ones((3, 4), np.float32),
                                 "b": np.zeros((4,), np.float32)},
                       "bn": {"scale": np.full((4,), 2.0, np.float32),
                              "bias": np.full((4,), 3.0, np.float32)}},
            "step": np.asarray(7),
        }

    def test_roundtrip_v2(self, tmp_path):
        from weaksuppointcloudseg_tpu.utils.checkpoint import (
            save_checkpoint, restore_checkpoint)

        tree = self._tree()
        p = str(tmp_path / "ck")
        save_checkpoint(p, tree)
        data = np.load(p + ".npz")
        assert "__keypaths__" in data.files and "__format__" in data.files
        out = restore_checkpoint(p, jax.tree_util.tree_map(np.zeros_like, tree))
        jax.tree_util.tree_map(np.testing.assert_array_equal, out, tree)

    def test_restore_into_renamed_leaf_fails_loudly(self, tmp_path):
        """scale/bias are both [4]-shaped: a v1 positional restore into a
        renamed structure would silently swap them; v2 must raise."""
        from weaksuppointcloudseg_tpu.utils.checkpoint import (
            save_checkpoint, restore_checkpoint)

        tree = self._tree()
        p = str(tmp_path / "ck")
        save_checkpoint(p, tree)
        bad = self._tree()
        bad["params"]["bn"] = {"gamma": bad["params"]["bn"].pop("scale"),
                               "beta": bad["params"]["bn"].pop("bias")}
        with pytest.raises(ValueError, match="structure mismatch"):
            restore_checkpoint(p, bad)

    def test_restore_into_different_leaf_count_fails_loudly(self, tmp_path):
        from weaksuppointcloudseg_tpu.utils.checkpoint import (
            save_checkpoint, restore_checkpoint)

        tree = self._tree()
        p = str(tmp_path / "ck")
        save_checkpoint(p, tree)
        bad = self._tree()
        del bad["params"]["bn"]["bias"]
        with pytest.raises(ValueError, match="structure mismatch"):
            restore_checkpoint(p, bad)

    def test_legacy_v1_positional_restore_still_works(self, tmp_path):
        from weaksuppointcloudseg_tpu.utils.checkpoint import (
            restore_checkpoint)

        tree = self._tree()
        flat, _ = jax.tree_util.tree_flatten(tree)
        p = str(tmp_path / "legacy.npz")
        np.savez(p, **{f"arr_{i}": np.asarray(x) for i, x in enumerate(flat)})
        out = restore_checkpoint(p, jax.tree_util.tree_map(np.zeros_like, tree))
        jax.tree_util.tree_map(np.testing.assert_array_equal, out, tree)
