"""S3DIS indoor semantic-segmentation data pipeline.

Rebuild of S3DIS/DataIO_S3DIS.py:

- ``S3DISDataset``: loads every block shard listed in ``all_files.txt``
  (fields ``data`` [S,4096,9], ``label`` [S,4096] — DataIO_S3DIS.py:36-58;
  the reference's ``.h5`` or ``.npz`` with the same fields, data/shards.py)
  and splits train/test by matching ``Area_<k>`` against ``room_filelist.txt``
  (DataIO_S3DIS.py:60-83).
- ``room_to_blocks``: the test-time 1m x 1m block sweep with >=100-pt filter,
  sample/duplicate to ``num_point`` points, and 9-channel featurization
  (DataIO_S3DIS.py:301-433). Channel layout (doc at DataIO_S3DIS.py:122):
  0:3 xyz with the block xy-centered, 3:6 rgb/255, 6:9 xyz normalized by the
  room extent.
- ``S3DISTestRooms``: per-room iteration from ``meta/<area>_data_label.txt``
  (DataIO_S3DIS.py:254-299) — with quirk Q6 (the leading '/' that discards
  the base path in os.path.join) fixed.

The block sweep keeps the reference's inclusive boundaries (a point on a
block edge belongs to both neighbors), which rules out a plain histogram
pass; the scan is per-block but runs on contiguous numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from weaksuppointcloudseg_tpu.data.shards import read_shard, write_shard

NUM_CLASSES = 13


def load_block_shard(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read one .h5/.npz block shard -> (data [S,N,9], label [S,N])."""
    f = read_shard(path)
    return np.asarray(f["data"], np.float32), np.asarray(f["label"], np.int32)


def weak_class_onehot(seg: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """[B, num_classes] multi-hot of classes present per block (vectorized)."""
    b = seg.shape[0]
    out = np.zeros((b, num_classes), np.float32)
    out[np.repeat(np.arange(b), seg.shape[1]), seg.reshape(-1)] = 1.0
    return out


@dataclasses.dataclass
class Batch:
    data: np.ndarray  # [B, N, 9]
    seg: np.ndarray  # [B, N]
    sample_ids: np.ndarray  # [B] global block index
    valid: int


class S3DISDataset:
    """All-blocks shard load + area-based train/test split."""

    def __init__(self, h5filepath: str, num_classes: int = NUM_CLASSES):
        self.base = h5filepath
        self.num_classes = num_classes
        with open(os.path.join(h5filepath, "all_files.txt")) as f:
            self.all_files = [line.strip() for line in f if line.strip()]
        with open(os.path.join(h5filepath, "room_filelist.txt")) as f:
            self.room_filelist = [line.strip() for line in f if line.strip()]
        self._data = None
        self._label = None

    def load_all(self) -> None:
        if self._data is not None:
            return
        datas, labels = [], []
        for fname in self.all_files:
            # reference keeps only the basename after the first '/'
            # (DataIO_S3DIS.py:54)
            d, l = load_block_shard(os.path.join(self.base, os.path.basename(fname)))
            datas.append(d)
            labels.append(l)
        self._data = np.concatenate(datas)
        self._label = np.concatenate(labels)

    @property
    def data(self) -> np.ndarray:
        self.load_all()
        return self._data

    @property
    def label(self) -> np.ndarray:
        self.load_all()
        return self._label

    def split_indices(self, test_area: int) -> Tuple[np.ndarray, np.ndarray]:
        """(train_idx, test_idx) by Area_<k> room-name match."""
        key = f"Area_{test_area}"
        rooms = np.asarray(self.room_filelist)
        is_test = np.char.find(rooms, key) >= 0
        idx = np.arange(len(rooms))
        return idx[~is_test], idx[is_test]

    def batches(
        self,
        indices: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> Iterator[Batch]:
        order = np.array(indices)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_last:
                    return
                idx = np.concatenate([idx, order[: batch_size - valid]])
            seg = self.label[idx]
            yield Batch(
                data=self.data[idx],
                seg=seg,
                sample_ids=idx,
                valid=valid,
            )


def sample_to_num_points(
    n: int, num_point: int, rng: np.random.Generator
) -> np.ndarray:
    """Index resample matching DataIO_S3DIS.py:417-433 (sample_data)."""
    if n == num_point:
        return np.arange(n)
    if n > num_point:
        return rng.choice(n, num_point)
    return np.concatenate([np.arange(n), rng.choice(n, num_point - n)])


def room_to_blocks(
    data_label: np.ndarray,
    num_point: int,
    *,
    block_size: float = 1.0,
    stride: float = 1.0,
    min_points: int = 100,
    random_sample: bool = False,
    sample_num: Optional[int] = None,
    sample_aug: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Room -> fixed-size 9-channel blocks (DataIO_S3DIS.py:301-414).

    Args:
      data_label: [N, 7] (xyz in meters shifted to min=origin, rgb 0-255,
        class label).
      random_sample: sample block corners uniformly instead of the regular
        stride sweep (DataIO_S3DIS.py:377-387), ``sample_num`` blocks
        (default: room-area estimate x ``sample_aug``).

    Returns:
      (blocks [K, num_point, 9] float32, labels [K, num_point] int32).
    """
    rng = rng or np.random.default_rng(0)
    data = np.array(data_label[:, 0:6], np.float64)
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.int32)
    max_room = data[:, 0:3].max(axis=0)

    limit = data[:, 0:3].max(axis=0)
    if random_sample:
        # random block corners (DataIO_S3DIS.py:377-387)
        if sample_num is None:
            nbx = int(np.ceil(limit[0] / block_size))
            nby = int(np.ceil(limit[1] / block_size))
            sample_num = nbx * nby * sample_aug
        corners = [
            (rng.uniform(-block_size, limit[0]), rng.uniform(-block_size, limit[1]))
            for _ in range(sample_num)
        ]
    else:
        num_block_x = int(np.ceil((limit[0] - block_size) / stride)) + 1
        num_block_y = int(np.ceil((limit[1] - block_size) / stride)) + 1
        corners = [
            (i * stride, j * stride)
            for i in range(num_block_x)
            for j in range(num_block_y)
        ]

    blocks, labels = [], []
    for xbeg, ybeg in corners:
        cond = (
            (data[:, 0] >= xbeg)
            & (data[:, 0] <= xbeg + block_size)
            & (data[:, 1] >= ybeg)
            & (data[:, 1] <= ybeg + block_size)
        )
        n_in = int(cond.sum())
        if n_in < min_points:
            continue
        block = data[cond]
        blab = label[cond]
        sel = sample_to_num_points(n_in, num_point, rng)
        block, blab = block[sel], blab[sel]

        out = np.zeros((num_point, 9), np.float32)
        out[:, 6] = block[:, 0] / max_room[0]
        out[:, 7] = block[:, 1] / max_room[1]
        out[:, 8] = block[:, 2] / max_room[2]
        block[:, 0] -= block[:, 0].min() + block_size / 2
        block[:, 1] -= block[:, 1].min() + block_size / 2
        out[:, 0:6] = block
        blocks.append(out)
        labels.append(blab)

    if not blocks:
        return (
            np.zeros((0, num_point, 9), np.float32),
            np.zeros((0, num_point), np.int32),
        )
    return np.stack(blocks), np.stack(labels)


class S3DISTestRooms:
    """Room-by-room test iteration (DataIO_S3DIS.py:254-299, Q6 fixed)."""

    def __init__(self, base_dir: str, test_area: str = "area5", num_point: int = 4096):
        self.num_point = num_point
        meta = os.path.join(base_dir, "meta", f"{test_area}_data_label.txt")
        with open(meta) as f:
            self.room_paths = [
                os.path.join(base_dir, line.strip()) for line in f if line.strip()
            ]

    def __len__(self) -> int:
        return len(self.room_paths)

    def load_room(self, i: int, rng: Optional[np.random.Generator] = None):
        """Returns (blocks [K,N,9], labels [K,N], room_path, room_max [3]).

        ``room_max`` is the room's xyz extent in meters (the normalization
        scale of block channels 6:9) — multiplying channels 6:9 by it
        recovers global room coordinates, which room-level label
        propagation (train/loop.py::S3DISTrainer.test(room_lp=True)) needs
        to build one affinity graph across block boundaries.
        """
        path = self.room_paths[i]
        if path.endswith(".txt"):
            data_label = np.loadtxt(path)
        elif path.endswith(".npy"):
            data_label = np.load(path)
        else:
            raise ValueError(f"unknown room file type: {path}")
        blocks, labels = room_to_blocks(data_label, self.num_point, rng=rng)
        room_max = data_label[:, 0:3].max(axis=0).astype(np.float32)
        return blocks, labels, path, room_max


def write_synthetic(
    base_dir: str,
    *,
    num_rooms_per_area: int = 2,
    areas: Tuple[int, ...] = (1, 5),
    blocks_per_room: int = 4,
    num_points: int = 128,
    num_classes: int = NUM_CLASSES,
    room_xy: Tuple[float, float] = (2.0, 2.0),
    seed: int = 0,
) -> None:
    """Miniature S3DIS-format dataset: .npz block shards + raw .npy test
    rooms.

    Class labels correlate with height (z) so segmentation is learnable.
    ``room_xy`` is each raw room's floor extent in meters; a room yields
    about ``ceil(x) * ceil(y)`` 1 m blocks (``blocks_per_room`` caps the
    training blocks kept per room).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(base_dir, "meta"), exist_ok=True)

    all_data, all_labels, room_rows = [], [], []
    meta_rows = {a: [] for a in areas}
    for a in areas:
        for r in range(num_rooms_per_area):
            room_name = f"Area_{a}_room_{r}"
            # raw room: points in a room_xy x 3m box
            n_raw = blocks_per_room * num_points * 2
            xyz = rng.uniform([0, 0, 0], [*room_xy, 3.0], (n_raw, 3))
            rgb = rng.uniform(0, 255, (n_raw, 3))
            lab = np.minimum(
                (xyz[:, 2] / 3.0 * num_classes).astype(np.int64), num_classes - 1
            )
            room = np.concatenate([xyz, rgb, lab[:, None]], axis=1)
            rel = f"rooms/{room_name}.npy"
            os.makedirs(os.path.join(base_dir, "rooms"), exist_ok=True)
            np.save(os.path.join(base_dir, rel), room)
            meta_rows[a].append(rel)

            blocks, blabels = room_to_blocks(
                room, num_points, min_points=10, rng=rng
            )
            blocks, blabels = blocks[:blocks_per_room], blabels[:blocks_per_room]
            all_data.append(blocks)
            all_labels.append(blabels)
            room_rows += [room_name] * len(blocks)

    data = np.concatenate(all_data).astype(np.float32)
    labels = np.concatenate(all_labels).astype(np.int32)
    write_shard(os.path.join(base_dir, "ply_data_all_0.npz"),
                data=data, label=labels)
    with open(os.path.join(base_dir, "all_files.txt"), "w") as f:
        f.write("data/ply_data_all_0.npz\n")
    with open(os.path.join(base_dir, "room_filelist.txt"), "w") as f:
        f.write("\n".join(room_rows) + "\n")
    for a in areas:
        with open(os.path.join(base_dir, "meta", f"area{a}_data_label.txt"), "w") as f:
            f.write("\n".join(meta_rows[a]) + "\n")
