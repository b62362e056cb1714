"""ShapeNet part-segmentation data pipeline.

Rebuild of ShapeNet/DataIO_ShapeNet.py (class ``ShapeNetIO``):

- category / part-id maps from ``hdf5_data`` (all_object_categories.txt,
  overallid_to_catid_partid.json, catid_partid_to_overallid.json —
  DataIO_ShapeNet.py:18-50; NUM_CATEGORIES=16, NUM_PART_CATS=50).
- train/val shard concatenation (fields ``data`` [S,2048,3], ``label``
  [S,1], ``pid`` [S,2048] — DataIO_ShapeNet.py:317-325); shards are the
  reference's ``.h5`` or ``.npz`` with the same fields (data/shards.py).
- test set from raw .pts/.seg files listed in testing_ply_file_list.txt with
  part-id remapping via catid_partid -> overall id and unit-sphere
  normalization (DataIO_ShapeNet.py:122-142, 235-344).
- per-sample weak category one-hot derived from seg labels
  (DataIO_ShapeNet.py:188-192) — vectorized here.

Design: instead of the reference's stateful pointer loader, a
dataset object yields *fixed-shape* numpy batches (drop-last for training,
zero-pad + valid-count for eval) so every jit signature is compiled once.
``write_synthetic`` produces a miniature self-consistent dataset for tests,
demos, and benchmarks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from weaksuppointcloudseg_tpu.data.shards import read_shard, write_shard

NUM_CATEGORIES = 16
NUM_PART_CATS = 50
# parts per category of the real dataset, in its category order (airplane,
# bag, cap, car, chair, earphone, guitar, knife, lamp, laptop, motorbike,
# mug, pistol, rocket, skateboard, table): 50 part classes in all
SHAPENET_PARTS = (4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3)


@dataclasses.dataclass
class ShapeNetMeta:
    """Category/part-id maps (DataIO_ShapeNet.py:18-50)."""

    objnames: List[str]
    objcats: List[str]  # category ids (e.g. '02691156')
    on2oid: dict  # catid -> category index
    cpid2oid: dict  # '<catid>_<partid>' -> overall part id
    object2setofoid: dict  # catid -> list of overall part ids
    num_categories: int = NUM_CATEGORIES
    num_part_cats: int = NUM_PART_CATS

    @classmethod
    def load(cls, h5_base_path: str) -> "ShapeNetMeta":
        with open(os.path.join(h5_base_path, "all_object_categories.txt")) as f:
            pairs = [line.split() for line in f.read().splitlines() if line.strip()]
        objnames = [p[0] for p in pairs]
        objcats = [p[1] for p in pairs]
        with open(os.path.join(h5_base_path, "overallid_to_catid_partid.json")) as f:
            oid2cpid = json.load(f)
        with open(os.path.join(h5_base_path, "catid_partid_to_overallid.json")) as f:
            cpid2oid = json.load(f)
        object2setofoid: dict = {}
        for idx, (objid, _pid) in enumerate(oid2cpid):
            object2setofoid.setdefault(objid, []).append(idx)
        return cls(
            objnames=objnames,
            objcats=objcats,
            on2oid={c: i for i, c in enumerate(objcats)},
            cpid2oid=cpid2oid,
            object2setofoid=object2setofoid,
            num_categories=len(objcats),
            num_part_cats=len(oid2cpid),
        )

    def iou_oids(self, category_index: int) -> List[int]:
        """Overall part ids belonging to one shape category."""
        return self.object2setofoid[self.objcats[category_index]]


def load_seg_shard(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read one .h5/.npz shard -> (data [S,N,3], label [S], seg [S,N])."""
    f = read_shard(path)
    data, label, seg = f["data"], f["label"], f["pid"]
    return (
        np.asarray(data, np.float32),
        np.asarray(label).reshape(-1).astype(np.int32),
        np.asarray(seg, np.int32),
    )


def weak_category_onehot(seg: np.ndarray, num_part_cats: int = NUM_PART_CATS) -> np.ndarray:
    """[B, num_part_cats] multi-hot of the part classes present per sample.

    Vectorized replacement for the per-sample np.unique loops
    (DataIO_ShapeNet.py:188-192).
    """
    b = seg.shape[0]
    out = np.zeros((b, num_part_cats), np.float32)
    out[np.repeat(np.arange(b), seg.shape[1]), seg.reshape(-1)] = 1.0
    return out


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + scale to the unit sphere (DataIO_ShapeNet.py:337-344)."""
    pc = pc - pc.mean(axis=0)
    return pc / np.max(np.sqrt(np.sum(pc**2, axis=1)))


def resample_to_fixed(
    n_points: int, target: int, rng: np.random.Generator
) -> np.ndarray:
    """Indices that resample a cloud to exactly ``target`` points.

    Generalizes the duplicate-then-slice trick at
    ShapeNet_DGCNN_trainer.py:530-535 — and fixes quirk Q3 (the reference
    crashes for shapes with > 3000 points) by subsampling in that case.
    """
    if n_points == target:
        return np.arange(target)
    if n_points > target:
        return rng.choice(n_points, target, replace=False)
    extra = rng.choice(n_points, target - n_points, replace=True)
    return np.concatenate([np.arange(n_points), extra])


def cover_partition(
    n_points: int, target: int, rng: np.random.Generator
) -> list:
    """Fixed-size index views whose union covers EVERY original point.

    <= target points: one duplicate-padded view, original points first (the
    reference's duplicate-then-slice trick,
    ShapeNet_DGCNN_trainer.py:530-535).
    >  target points: ceil(n/target) views of one random permutation, the
    last padded with already-covered indices. (The reference crashes on
    such shapes — quirk Q3; scoring every original point is the sound fix,
    where ``resample_to_fixed`` alone would score a subsample only.)
    """
    if n_points <= target:
        return [resample_to_fixed(n_points, target, rng)]
    perm = rng.permutation(n_points)
    views = []
    for s in range(0, n_points, target):
        chunk = perm[s:s + target]
        if len(chunk) < target:
            pad = rng.choice(s, target - len(chunk), replace=False)
            chunk = np.concatenate([chunk, perm[pad]])
        views.append(chunk)
    return views


@dataclasses.dataclass
class Batch:
    """One fixed-shape training/eval batch."""

    data: np.ndarray  # [B, N, 3]
    label: np.ndarray  # [B] category index
    seg: np.ndarray  # [B, N] part labels
    sample_ids: np.ndarray  # [B] global sample index (for SampIndex masks)
    valid: int  # number of real (non-padding) samples


class ShapeNetDataset:
    """Train/val splits concatenated from the shard lists."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.h5_base_path = os.path.join(base_dir, "hdf5_data")
        self.meta = ShapeNetMeta.load(self.h5_base_path)
        self._splits = {}

    def _load_split(self, list_name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with open(os.path.join(self.h5_base_path, list_name)) as f:
            files = [line.strip() for line in f if line.strip()]
        datas, labels, segs = [], [], []
        for fname in files:
            d, l, s = load_seg_shard(os.path.join(self.h5_base_path, os.path.basename(fname)))
            datas.append(d)
            labels.append(l)
            segs.append(s)
        return np.concatenate(datas), np.concatenate(labels), np.concatenate(segs)

    def split(self, name: str):
        """name: 'train' | 'val'. Returns (data, label, seg) arrays."""
        if name not in self._splits:
            self._splits[name] = self._load_split(f"{name}_hdf5_file_list.txt")
        return self._splits[name]

    def num_samples(self, name: str) -> int:
        return self.split(name)[0].shape[0]

    def batches(
        self,
        name: str,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> Iterator[Batch]:
        """Yield fixed-shape batches; the short tail is zero-padded (or
        dropped, matching the reference's training behavior at
        ShapeNet_DGCNN_trainer.py:163-164)."""
        data, label, seg = self.split(name)
        n = data.shape[0]
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_last:
                    return
                idx = np.concatenate([idx, np.zeros(batch_size - valid, np.int64)])
            yield Batch(
                data=data[idx],
                label=label[idx],
                seg=seg[idx],
                sample_ids=idx,
                valid=valid,
            )


class ShapeNetTestSet:
    """Raw .pts/.seg test files (DataIO_ShapeNet.py:122-142, 235-299)."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.ply_data_dir = os.path.join(base_dir, "PartAnnotation")
        self.meta = ShapeNetMeta.load(os.path.join(base_dir, "hdf5_data"))
        with open(os.path.join(base_dir, "testing_ply_file_list.txt")) as f:
            rows = [line.split() for line in f.read().splitlines() if line.strip()]
        self.pts_files = [r[0] for r in rows]
        self.seg_files = [r[1] for r in rows]
        self.labels = [r[2] for r in rows]

    def __len__(self) -> int:
        return len(self.pts_files)

    def __getitem__(self, i: int):
        """Returns (points [n,3] normalized, seg [n], category_index)."""
        cat_idx = self.meta.on2oid[self.labels[i]]
        catid = self.meta.objcats[cat_idx]
        pts = np.loadtxt(
            os.path.join(self.ply_data_dir, self.pts_files[i]), dtype=np.float32
        ).reshape(-1, 3)
        with open(os.path.join(self.ply_data_dir, self.seg_files[i])) as f:
            part_ids = np.array([int(x) for x in f.read().split()], np.int64)
        seg = np.array([self.meta.cpid2oid[f"{catid}_{p}"] for p in part_ids], np.int32)
        return pc_normalize(pts), seg, cat_idx


def write_synthetic(
    base_dir: str,
    *,
    num_categories: int = 4,
    parts_per_category: Union[int, Sequence[int]] = 3,
    train_samples: int = 32,
    val_samples: int = 8,
    test_samples: int = 4,
    num_points: int = 128,
    seed: int = 0,
) -> None:
    """Write a miniature self-consistent ShapeNet-format dataset.

    Shapes are per-category Gaussian clusters with spatially coherent part
    labels (parts split along z), so segmentation is actually learnable.
    ``parts_per_category`` is one count for every category or one per
    category (``SHAPENET_PARTS`` gives the real dataset's 50 part classes).
    Block shards are written as ``.npz``.
    """
    parts = ([parts_per_category] * num_categories
             if isinstance(parts_per_category, int)
             else list(parts_per_category))
    if len(parts) != num_categories:
        raise ValueError(f"{len(parts)} part counts for {num_categories} "
                         "categories")
    first_oid = np.concatenate([[0], np.cumsum(parts)[:-1]]).astype(int)
    rng = np.random.default_rng(seed)
    h5dir = os.path.join(base_dir, "hdf5_data")
    part_dir = os.path.join(base_dir, "PartAnnotation")
    os.makedirs(h5dir, exist_ok=True)

    cats = [(f"cat{c}", f"{2690000 + c}") for c in range(num_categories)]
    with open(os.path.join(h5dir, "all_object_categories.txt"), "w") as f:
        f.write("\n".join(f"{n}\t{cid}" for n, cid in cats) + "\n")

    oid2cpid, cpid2oid = [], {}
    for c, (_name, cid) in enumerate(cats):
        for p in range(parts[c]):
            cpid2oid[f"{cid}_{p + 1}"] = len(oid2cpid)
            oid2cpid.append([cid, p + 1])
    with open(os.path.join(h5dir, "overallid_to_catid_partid.json"), "w") as f:
        json.dump(oid2cpid, f)
    with open(os.path.join(h5dir, "catid_partid_to_overallid.json"), "w") as f:
        json.dump(cpid2oid, f)
    with open(os.path.join(h5dir, "part_color_mapping.json"), "w") as f:
        json.dump([[0.5, 0.5, 0.5]] * len(oid2cpid), f)

    def make_samples(n, force_category=None):
        data = np.empty((n, num_points, 3), np.float32)
        label = np.empty((n, 1), np.int64)
        seg = np.empty((n, num_points), np.int64)
        for i in range(n):
            c = int(rng.integers(num_categories)) if force_category is None else force_category
            pts = rng.standard_normal((num_points, 3)).astype(np.float32) * 0.3
            pts[:, 0] += c  # category-dependent offset
            # parts split along z into contiguous slabs
            z_rank = np.argsort(np.argsort(pts[:, 2]))
            part_local = (z_rank * parts[c]) // num_points
            data[i], label[i, 0], seg[i] = pts, c, first_oid[c] + part_local
        return data, label, seg

    for split, n in (("train", train_samples), ("val", val_samples)):
        fname = f"ply_data_{split}0.npz"
        d, l, s = make_samples(n)
        write_shard(os.path.join(h5dir, fname), data=d, label=l, pid=s)
        with open(os.path.join(h5dir, f"{split}_hdf5_file_list.txt"), "w") as f:
            f.write(fname + "\n")

    # raw-format test set
    rows = []
    for i in range(test_samples):
        c = int(rng.integers(num_categories))
        cid = cats[c][1]
        d, _, s = make_samples(1, force_category=c)
        n_pts = num_points - int(rng.integers(0, num_points // 4))  # ragged
        cat_dir_pts = os.path.join(part_dir, cid, "points")
        cat_dir_seg = os.path.join(part_dir, cid, "points_label")
        os.makedirs(cat_dir_pts, exist_ok=True)
        os.makedirs(cat_dir_seg, exist_ok=True)
        np.savetxt(os.path.join(cat_dir_pts, f"t{i}.pts"), d[0, :n_pts])
        local = s[0, :n_pts] - first_oid[c] + 1
        with open(os.path.join(cat_dir_seg, f"t{i}.seg"), "w") as f:
            f.write("\n".join(str(int(x)) for x in local) + "\n")
        rows.append(
            f"{cid}/points/t{i}.pts {cid}/points_label/t{i}.seg {cid}"
        )
    with open(os.path.join(base_dir, "testing_ply_file_list.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
