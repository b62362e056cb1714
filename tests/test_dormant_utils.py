"""Dormant-utility rebuilds: euler/quaternion conversions, h5 prep
helpers, S3DIS room2samples + bbox exports."""

import os

import numpy as np
import pytest

from weaksuppointcloudseg_tpu.utils import rotations as rot
from weaksuppointcloudseg_tpu.data import prep_util, indoor3d


class TestRotations:
    def test_euler2mat_basic(self):
        np.testing.assert_allclose(rot.euler2mat(), np.eye(3), atol=1e-12)
        # 90 deg about z maps x-axis to y-axis
        m = rot.euler2mat(z=np.pi / 2)
        np.testing.assert_allclose(m @ [1, 0, 0], [0, 1, 0], atol=1e-12)
        # composition order: x applied first
        z, y, x = 0.3, -0.2, 0.5
        np.testing.assert_allclose(
            rot.euler2mat(z, y, x),
            rot.euler2mat(z=z) @ rot.euler2mat(y=y) @ rot.euler2mat(x=x),
            atol=1e-12)

    def test_mat2euler_roundtrip(self, rng):
        for _ in range(20):
            z, y, x = rng.uniform(-np.pi, np.pi), rng.uniform(
                -np.pi / 2 + 0.01, np.pi / 2 - 0.01), rng.uniform(
                -np.pi, np.pi)
            z2, y2, x2 = rot.mat2euler(rot.euler2mat(z, y, x))
            np.testing.assert_allclose([z2, y2, x2], [z, y, x], atol=1e-9)

    def test_quat_roundtrip(self, rng):
        for _ in range(10):
            z, y, x = rng.uniform(-1.2, 1.2, 3)
            q = rot.euler2quat(z, y, x)
            assert np.linalg.norm(q) == pytest.approx(1.0)
            np.testing.assert_allclose(rot.quat2mat(q),
                                       rot.euler2mat(z, y, x), atol=1e-9)
            np.testing.assert_allclose(rot.quat2euler(q), (z, y, x),
                                       atol=1e-9)

    def test_angle_axis_roundtrip(self, rng):
        for _ in range(10):
            z, y, x = rng.uniform(-1.2, 1.2, 3)
            theta, vec = rot.euler2angle_axis(z, y, x)
            assert np.linalg.norm(vec) == pytest.approx(1.0)
            np.testing.assert_allclose(
                rot.angle_axis2euler(theta, vec), (z, y, x), atol=1e-9)

    def test_gimbal_lock(self):
        m = rot.euler2mat(z=0.4, y=np.pi / 2, x=0.2)
        z, y, x = rot.mat2euler(m)
        # degenerate: x folded into z; the matrix must still round-trip
        np.testing.assert_allclose(rot.euler2mat(z, y, x), m, atol=1e-6)


class TestPrepUtil:
    def test_h5_roundtrips(self, tmp_path, rng):
        data = rng.standard_normal((4, 16, 3)).astype(np.float32)
        label = rng.integers(0, 5, (4, 1)).astype(np.uint8)
        seg = rng.integers(0, 7, (4, 16)).astype(np.uint8)
        normal = rng.standard_normal((4, 16, 3)).astype(np.float32)

        p = str(tmp_path / "a.h5")
        prep_util.save_h5(p, data, label, "float32", "uint8")
        d, l = prep_util.load_h5(p)
        np.testing.assert_allclose(d, data)
        np.testing.assert_array_equal(l, label)

        p = str(tmp_path / "b.h5")
        prep_util.save_h5_data_label_normal(p, data, label, normal)
        d, l, n = prep_util.load_h5_data_label_normal(p)
        np.testing.assert_allclose(n, normal)

        p = str(tmp_path / "c.h5")
        prep_util.save_h5_data_label_seg(p, data, label, seg)
        d, l, s = prep_util.load_h5_data_label_seg(p)
        np.testing.assert_array_equal(s, seg)
        # field names interchange with the reference loaders (pid)
        from weaksuppointcloudseg_tpu.data.shapenet import load_seg_shard
        d2, l2, s2 = load_seg_shard(p)
        np.testing.assert_array_equal(s2, seg)

    def test_ply_and_pad(self, tmp_path, rng):
        pc = rng.standard_normal((10, 3)).astype(np.float32)
        p = str(tmp_path / "x.ply")
        prep_util.export_ply(pc, p)
        back = prep_util.load_ply_data(p, 6)
        np.testing.assert_allclose(back, pc[:6], atol=1e-5)
        arr = np.arange(6.0).reshape(3, 2)
        assert prep_util.pad_arr_rows(arr, 2).shape == (2, 2)
        padded = prep_util.pad_arr_rows(arr, 5)
        np.testing.assert_array_equal(padded[3], arr[-1])  # edge pad

    def test_batch_mkdir(self, tmp_path):
        prep_util.batch_mkdir(str(tmp_path / "root"), ["a", "b/c"])
        assert os.path.isdir(tmp_path / "root" / "a")


@pytest.fixture
def anno_dir(tmp_path, rng):
    d = tmp_path / "Annotations"
    d.mkdir()
    for name, lo in (("chair_1", [0.0, 0.0, 0.0]), ("table_1", [2.0, 2.0, 0.0]),
                     ("staris_1", [4.0, 0.0, 0.0])):  # typo class -> clutter
        pts = rng.uniform(0, 1, (30, 3)) + lo
        rgb = rng.integers(0, 255, (30, 3))
        np.savetxt(str(d / f"{name}.txt"), np.hstack([pts, rgb]))
    return str(d)


class TestIndoor3DDormant:
    def test_room_to_samples_covers_room(self, rng):
        n, num_point = 150, 64
        data = rng.uniform(0, 3, (n, 6)).astype(np.float32)
        label = rng.integers(0, 13, n).astype(np.uint8)
        batch, labels = indoor3d.room_to_samples(data, label, num_point, rng)
        assert batch.shape == (3, 64, 6) and labels.shape == (3, 64, 1)
        # every original point appears (shuffle covers all, pad duplicates)
        flat = batch.reshape(-1, 6)
        for i in range(0, n, 17):
            assert (np.abs(flat - data[i]).sum(1) < 1e-6).any()

    def test_room_to_samples_normalized_channels(self, rng):
        n = 100
        dl = np.hstack([
            rng.uniform(0, 4, (n, 3)), rng.integers(0, 255, (n, 3)),
            rng.integers(0, 13, (n, 1))]).astype(np.float32)
        out, labels = indoor3d.room_to_samples_normalized(dl, 32, rng)
        assert out.shape[-1] == 9
        assert out[:, :, 3:6].max() <= 1.0
        # channels 6:9 are room-max-normalized raw coords (NOT centered)
        np.testing.assert_allclose(
            out[:, :, 6:9],
            out[:, :, 0:3] / dl[:, 0:3].max(axis=0), rtol=1e-5)

    def test_collect_bounding_box(self, anno_dir, tmp_path):
        out = str(tmp_path / "bbox.txt")
        indoor3d.collect_bounding_box(anno_dir, out)
        bbox = np.loadtxt(out)
        assert bbox.shape == (3, 7)
        assert bbox[:, 0:3].min() == pytest.approx(0.0)  # shifted to origin
        assert (bbox[:, 3:6] >= bbox[:, 0:3]).all()
        labels = set(bbox[:, 6].astype(int))
        assert indoor3d.CLASS2LABEL["clutter"] in labels  # staris -> clutter

    def test_collect_point_bounding_box(self, anno_dir, tmp_path):
        out = str(tmp_path / "pb.npy")
        indoor3d.collect_point_bounding_box(anno_dir, out, "numpy")
        pb = np.load(out)
        assert pb.shape == (90, 13)
        # offsets point from each point to its box center; half-extents >= 0
        assert (pb[:, 10:13] >= 0).all()
        # center = point + offset must lie inside [point - 2*half, ...] bounds
        assert (np.abs(pb[:, 7:10]) <= pb[:, 10:13] + 1e-6).all()

    def test_bbox_label_to_obj(self, anno_dir, tmp_path):
        bb = str(tmp_path / "bbox.txt")
        indoor3d.collect_bounding_box(anno_dir, bb)
        prefix = str(tmp_path / "viz")
        indoor3d.bbox_label_to_obj(bb, prefix)
        obj = open(prefix + ".obj").read()
        assert obj.count("\nv ") + obj.startswith("v ") == 24  # 3 boxes x 8
        assert obj.count("\nf ") == 18  # 3 boxes x 6 quads
        assert os.path.exists(prefix + ".mtl")


class TestVoxelization:
    def test_volume_roundtrip(self, rng):
        from weaksuppointcloudseg_tpu.utils import pointcloud_io as pio
        pts = rng.uniform(-0.9, 0.9, (50, 3)).astype(np.float32)
        vol = pio.point_cloud_to_volume(pts, 16)
        assert vol.shape == (16, 16, 16)
        assert 0 < vol.sum() <= 50
        back = pio.volume_to_point_cloud(vol)
        assert back.shape[1] == 3 and len(back) == vol.sum()
        # every original point maps into an occupied voxel
        loc = np.clip(((pts + 1.0) / (2.0 / 16)).astype(int), 0, 15)
        assert vol[loc[:, 0], loc[:, 1], loc[:, 2]].all()

    def test_batch_and_views(self, rng):
        from weaksuppointcloudseg_tpu.utils import pointcloud_io as pio
        pcs = rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32)
        flat = pio.point_cloud_to_volume_batch(pcs, vsize=8)
        assert flat.shape == (3, 512)
        cube = pio.point_cloud_to_volume_batch(pcs, vsize=8, flatten=False)
        assert cube.shape == (3, 8, 8, 8, 1)
        img = pio.point_cloud_three_views(pcs[0], resolution=64)
        assert img.shape == (64, 192)
        assert img.max() > 0
