"""Dataset shards: the ``.npz`` form the synthetic writers produce, the
reference's ``.h5`` form (h5py imported only to read one), and the
loaders' choice by file extension."""

import os
import subprocess
import sys

import numpy as np
import pytest

from weaksuppointcloudseg_tpu.data import s3dis, shapenet
from weaksuppointcloudseg_tpu.data.shards import read_shard, write_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(rng):
    return {
        "data": rng.standard_normal((3, 16, 9)).astype(np.float32),
        "label": rng.integers(0, 13, (3, 16)).astype(np.uint8),
        "pid": rng.integers(0, 50, (3, 16)).astype(np.int32),
    }


def test_npz_round_trip(tmp_path, rng):
    arrays = _arrays(rng)
    path = str(tmp_path / "sub" / "ply_data_train0.npz")
    write_shard(path, **arrays)
    got = read_shard(path)
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def test_h5_and_npz_read_alike(tmp_path, rng):
    h5py = pytest.importorskip("h5py")
    arrays = _arrays(rng)
    write_shard(str(tmp_path / "a.npz"), **arrays)
    with h5py.File(tmp_path / "a.h5", "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    a, b = read_shard(str(tmp_path / "a.npz")), read_shard(
        str(tmp_path / "a.h5"))
    for k in arrays:
        np.testing.assert_array_equal(a[k], b[k])


def test_h5_without_h5py_names_the_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)    # import fails
    with pytest.raises(ImportError, match="h5py"):
        read_shard(str(tmp_path / "ply_data_train0.h5"))


@pytest.mark.parametrize("path,match", [("x.txt", "unknown shard"),
                                        ("x.h5", "written as .npz")])
def test_bad_extension(tmp_path, path, match):
    fn = read_shard if match == "unknown shard" else (
        lambda p: write_shard(p, data=np.zeros(2)))
    with pytest.raises(ValueError, match=match):
        fn(str(tmp_path / path))


def test_shapenet_synthetic_round_trip(tmp_path):
    d = str(tmp_path)
    shapenet.write_synthetic(d, num_points=32, train_samples=6,
                             val_samples=2, test_samples=2)
    shard = os.path.join(d, "hdf5_data", "ply_data_train0.npz")
    data, label, seg = shapenet.load_seg_shard(shard)
    assert data.shape == (6, 32, 3) and label.shape == (6,)
    assert seg.shape == (6, 32) and data.dtype == np.float32
    ds = shapenet.ShapeNetDataset(d)
    assert ds.num_samples("train") == 6
    np.testing.assert_array_equal(ds.split("train")[0], data)


def test_s3dis_synthetic_round_trip(tmp_path):
    d = str(tmp_path)
    s3dis.write_synthetic(d, num_points=32)
    data, label = s3dis.load_block_shard(
        os.path.join(d, "ply_data_all_0.npz"))
    assert data.shape[1:] == (32, 9) and label.shape == data.shape[:2]
    ds = s3dis.S3DISDataset(d)
    assert len(ds.room_filelist) == data.shape[0]


def test_synthetic_path_never_imports_h5py(tmp_path):
    """Writing and loading both synthetic datasets works on a machine
    without h5py: the package is never imported."""
    code = (
        "import sys\n"
        "from weaksuppointcloudseg_tpu.data import s3dis, shapenet\n"
        f"shapenet.write_synthetic({str(tmp_path / 'sn')!r}, num_points=32,"
        " train_samples=4, val_samples=2, test_samples=2)\n"
        f"shapenet.ShapeNetDataset({str(tmp_path / 'sn')!r})\n"
        f"s3dis.write_synthetic({str(tmp_path / 's3')!r}, num_points=32)\n"
        f"s3dis.S3DISDataset({str(tmp_path / 's3')!r})\n"
        "assert 'h5py' not in sys.modules, 'h5py was imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
