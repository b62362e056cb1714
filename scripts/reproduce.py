"""One-command reproduction of the reference's headline benchmark table.

The framework's accuracy-parity claim (reference mIoU at 10% labels,
arXiv:2004.04091) cannot be *run* in an egress-free environment — this
script is the committed runbook that produces the BASELINE.md table the
moment the datasets exist on disk (docs/reproduce.md):

    python scripts/reproduce.py --dataset both --data-root ./Dataset

runs the EXACT reference configs (/root/reference/train_script:1-5):

    train_shapenet -m 0.1 -sty Full -bs 32 --Epoch 201
    train_s3dis    -m 0.1 -sty Full -bs 14 --Epoch 201 -ta 5

then the matching test CLIs with label propagation, checks the produced
Summary.txt format against the committed golden sample (docs/golden/), and
writes a BASELINE.md-style results table.

``--smoke`` swaps in generated synthetic datasets + tiny epochs so the whole
pipeline is CI-able end-to-end without real data (what tests and the round
evidence use).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GOLDEN_DIR = os.path.join(REPO, "docs", "golden")


def _newest_result_dir(dataset: str) -> str:
    root = os.path.join(os.getcwd(), "Results", dataset)
    dirs = [os.path.join(root, d) for d in os.listdir(root)]
    return max(dirs, key=os.path.getmtime)


def _stamp(result_dir: str) -> str:
    # <Net>_sty-<Style>_m-<m>_<datetime> -> the trailing datetime stamp
    return "_".join(os.path.basename(result_dir).split("_")[-2:])


def _line_signature(line: str) -> str:
    """Replace every number with '#' — the format skeleton of a line."""
    sig = re.sub(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?", "#", line.strip())
    return re.sub(r"#(?:,#)+", "#", sig)  # thousands separators


def check_summary_format(summary_path: str, golden_path: str) -> None:
    """Every golden line skeleton must appear in the produced Summary.txt
    (format parity with the reference-era Summary layout)."""
    got = {_line_signature(ln) for ln in open(summary_path) if ln.strip()}
    missing = []
    for ln in open(golden_path):
        if ln.strip() and not ln.startswith("#"):
            sig = _line_signature(ln)
            if sig not in got:
                missing.append(sig)
    if missing:
        raise SystemExit(
            f"Summary.txt format drifted from {golden_path}; missing line "
            f"skeletons:\n  " + "\n  ".join(missing))
    print(f"Summary format OK vs {os.path.basename(golden_path)}")


def _capture(fn, argv):
    buf = io.StringIO()

    class Tee(io.StringIO):
        def write(self, s):
            sys.__stdout__.write(s)
            return buf.write(s)

    with contextlib.redirect_stdout(Tee()):
        fn(argv)
    return buf.getvalue()


def _parse_metrics(pattern: str, out: str) -> "re.Match":
    """re.search that fails loudly: the test CLIs' printed metric line is
    this script's interface, and a silent None would crash with an opaque
    AttributeError AFTER the (up to 201-epoch) training run finished."""
    mm = re.search(pattern, out)
    if mm is None:
        raise RuntimeError(
            "could not parse the test CLI output (expected %r); output "
            "was:\n%s" % (pattern, out[-2000:]))
    return mm


def run_shapenet(args, m=None) -> dict:
    from weaksuppointcloudseg_tpu.cli import test_shapenet, train_shapenet

    data = os.path.join(args.data_root, "ShapeNet")
    if args.smoke:
        from weaksuppointcloudseg_tpu.data import shapenet
        if not os.path.isdir(os.path.join(data, "hdf5_data")):
            shapenet.write_synthetic(data, train_samples=8, val_samples=4,
                                     test_samples=3, num_points=64, seed=0)
    epochs = args.smoke_epochs if args.smoke else 201
    bs = 2 if args.smoke else 32
    if m is None:
        m = 0.5 if args.smoke else args.m
    train_shapenet.main([
        "-m", str(m), "-sty", "Full", "-bs", str(bs),
        "--Epoch", str(epochs), "--ExpRslt", "1", "--DataPath", data])
    rdir = _newest_result_dir("ShapeNet")
    check_summary_format(
        os.path.join(rdir, "Summary", "Summary.txt"),
        os.path.join(GOLDEN_DIR, "Summary_ShapeNet_golden.txt"))
    out = _capture(test_shapenet.main, [
        "-dt", _stamp(rdir), "-style", "Full", "--DataPath", data]
        + (["--num_points", "96"] if args.smoke else []))
    mm = _parse_metrics(r"perdata mIoU ([\d.]+)%\s+pershape mIoU "
                        r"([\d.]+)%\s+acc ([\d.]+)%", out)
    return {"dataset": "ShapeNet", "config": f"m={m} Full bs={bs} ep={epochs}",
            "perdata_miou": mm.group(1), "pershape_miou": mm.group(2),
            "acc": mm.group(3), "result_dir": rdir}


def run_s3dis(args, m=None) -> dict:
    from weaksuppointcloudseg_tpu.cli import test_s3dis, train_s3dis

    base = os.path.join(args.data_root, "S3DIS")
    data = os.path.join(base, "indoor3d_sem_seg_hdf5_data")
    if args.smoke:
        from weaksuppointcloudseg_tpu.data import s3dis
        if not os.path.isdir(data):
            s3dis.write_synthetic(data, num_points=64, seed=0)
    epochs = args.smoke_epochs if args.smoke else 201
    bs = 2 if args.smoke else 14
    if m is None:
        m = 0.5 if args.smoke else args.m
    train_s3dis.main([
        "-m", str(m), "-sty", "Full", "-bs", str(bs),
        "--Epoch", str(epochs), "-ta", "5", "--ExpRslt", "1",
        "--DataPath", data])
    rdir = _newest_result_dir("S3DIS")
    check_summary_format(
        os.path.join(rdir, "Summary", "Summary.txt"),
        os.path.join(GOLDEN_DIR, "Summary_S3DIS_golden.txt"))
    # synthetic datasets keep meta/ + rooms/ next to the block shards; real
    # S3DIS has them in the dataset base dir (prepare scripts' layout)
    rooms = data if args.smoke else base
    out = _capture(test_s3dis.main, [
        "-dt", _stamp(rdir), "-style", "Full", "-ta", "5",
        "--DataPath", data, "--RoomsPath", rooms])
    mm = _parse_metrics(r"mIoU ([\d.]+)%\s+acc ([\d.]+)%", out)
    return {"dataset": "S3DIS (Area 5)",
            "config": f"m={m} Full bs={bs} ep={epochs} ta=5",
            "miou": mm.group(1), "acc": mm.group(2), "result_dir": rdir}


def _vd_err(problems, cond, msg):
    if not cond:
        problems.append(msg)
    return cond


def validate_shapenet_data(base_dir: str) -> list:
    """Check an externally-provided ShapeNet tree against the layout the
    loaders expect (data/shapenet.py; reference: DataIO_ShapeNet.py:18-50,
    53-117, 122-142). Returns a list of problems (empty = ready)."""
    import json as _json

    from weaksuppointcloudseg_tpu.data.shards import read_shard

    problems = []
    h5dir = os.path.join(base_dir, "hdf5_data")
    if not _vd_err(problems, os.path.isdir(h5dir), f"missing dir {h5dir}"):
        return problems
    for fname in ("all_object_categories.txt",
                  "overallid_to_catid_partid.json",
                  "catid_partid_to_overallid.json"):
        _vd_err(problems, os.path.isfile(os.path.join(h5dir, fname)),
                f"missing {h5dir}/{fname}")
    if problems:
        return problems
    cats = [ln.split() for ln in open(
        os.path.join(h5dir, "all_object_categories.txt")) if ln.strip()]
    _vd_err(problems, all(len(c) == 2 for c in cats),
            "all_object_categories.txt rows must be '<name> <catid>'")
    oid_map = _json.load(open(
        os.path.join(h5dir, "overallid_to_catid_partid.json")))
    num_parts = len(oid_map)
    n_pts = None
    for split in ("train", "val"):
        lst = os.path.join(h5dir, f"{split}_hdf5_file_list.txt")
        if not _vd_err(problems, os.path.isfile(lst), f"missing {lst}"):
            continue
        names = [ln.strip() for ln in open(lst) if ln.strip()]
        _vd_err(problems, len(names) > 0, f"{lst} lists no shard files")
        for name in names:
            h5path = os.path.join(h5dir, os.path.basename(name))
            if not _vd_err(problems, os.path.isfile(h5path),
                           f"missing {h5path} (listed in {split} list)"):
                continue
            f = read_shard(h5path)
            for field in ("data", "label", "pid"):
                if not _vd_err(problems, field in f,
                               f"{h5path}: missing dataset '{field}'"):
                    break
            else:
                d, l, s = f["data"], f["label"], f["pid"]
                _vd_err(problems,
                        d.ndim == 3 and d.shape[-1] == 3,
                        f"{h5path}: data must be [B,N,3], got {d.shape}")
                _vd_err(problems, s.shape[:2] == d.shape[:2],
                        f"{h5path}: pid {s.shape} != data rows "
                        f"{d.shape[:2]}")
                _vd_err(problems, l.shape[0] == d.shape[0],
                        f"{h5path}: label rows {l.shape[0]} != "
                        f"{d.shape[0]}")
                smax = int(np.asarray(s[:1]).max()) if len(s) else 0
                _vd_err(problems, smax < num_parts,
                        f"{h5path}: pid value {smax} >= {num_parts} "
                        "part classes")
                n_pts = d.shape[1] if n_pts is None else n_pts
    test_list = os.path.join(base_dir, "testing_ply_file_list.txt")
    if _vd_err(problems, os.path.isfile(test_list),
               f"missing {test_list}"):
        rows = [ln.split() for ln in open(test_list) if ln.strip()]
        _vd_err(problems, all(len(r) >= 2 for r in rows),
                "testing_ply_file_list.txt rows must be '<pts> <seg> ...'")
        for r in rows[:3]:  # spot-check existence + parse
            pts = os.path.join(base_dir, "PartAnnotation", r[0])
            seg = os.path.join(base_dir, "PartAnnotation", r[1])
            if _vd_err(problems, os.path.isfile(pts), f"missing {pts}") and \
               _vd_err(problems, os.path.isfile(seg), f"missing {seg}"):
                arr = np.loadtxt(pts, dtype=np.float32, ndmin=2)
                _vd_err(problems, arr.shape[1] == 3,
                        f"{pts}: expected 3 columns, got {arr.shape[1]}")
    # label budgets: reference .mat files are optional (seeded generator
    # covers the absent ones — data/sampling.py)
    pre = os.path.join(base_dir, "Preprocess")
    found = sorted(os.path.basename(p) for p in glob_mats(pre))
    print("  SampIndex .mat files present: " + (", ".join(found) if found
          else "none (the seeded generator will be used — "
               "data/sampling.py:25)"))
    if found and n_pts:
        import scipy.io as scio

        for name in found:
            m = float(name.split("m-")[1][:-4])
            if m <= 0:
                continue  # ragged one-point-per-class layout
            mat = scio.loadmat(os.path.join(pre, name))
            key = [k for k in mat if not k.startswith("__")][0]
            idx = mat[key]
            _vd_err(problems, idx.ndim == 2 and
                    int(np.asarray(idx).max()) <= n_pts,
                    f"{name}: expected [num_train, floor(m*N)] indices "
                    f"< N={n_pts}, got shape {idx.shape} "
                    f"max {np.asarray(idx).max()}")
    return problems


def glob_mats(pre_dir: str) -> list:
    import glob as _glob

    return _glob.glob(os.path.join(pre_dir, "SampIndex_m-*.mat"))


def validate_s3dis_data(base_dir: str, test_area: int = 5) -> list:
    """Check an S3DIS tree against the loaders (data/s3dis.py; reference:
    DataIO_S3DIS.py:47-83, 254-267). Returns a list of problems."""
    from weaksuppointcloudseg_tpu.data.shards import read_shard

    problems = []
    for fname in ("all_files.txt", "room_filelist.txt"):
        _vd_err(problems, os.path.isfile(os.path.join(base_dir, fname)),
                f"missing {base_dir}/{fname}")
    if problems:
        return problems
    all_files = [ln.strip() for ln in
                 open(os.path.join(base_dir, "all_files.txt")) if ln.strip()]
    rooms = [ln.strip() for ln in
             open(os.path.join(base_dir, "room_filelist.txt")) if ln.strip()]
    _vd_err(problems, all(r.startswith("Area_") for r in rooms),
            "room_filelist.txt entries must start with 'Area_<k>_'")
    _vd_err(problems,
            any(f"Area_{test_area}" in r for r in rooms),
            f"no Area_{test_area} rooms in room_filelist.txt "
            f"(test split would be empty)")
    total = 0
    for name in all_files:
        h5path = os.path.join(base_dir, os.path.basename(name))
        if not _vd_err(problems, os.path.isfile(h5path),
                       f"missing {h5path} (listed in all_files.txt)"):
            continue
        f = read_shard(h5path)
        if not _vd_err(problems, "data" in f and "label" in f,
                       f"{h5path}: needs 'data' and 'label' datasets"):
            continue
        d, l = f["data"], f["label"]
        _vd_err(problems, d.ndim == 3 and d.shape[-1] == 9,
                f"{h5path}: data must be [B,4096,9] "
                f"(DataIO_S3DIS.py:122 channel doc), got {d.shape}")
        _vd_err(problems, l.shape[:2] == d.shape[:2],
                f"{h5path}: label {l.shape} != data rows {d.shape[:2]}")
        if len(l):
            lmax = int(np.asarray(l[:1]).max())
            _vd_err(problems, lmax < 13,
                    f"{h5path}: label value {lmax} >= 13 classes")
        total += d.shape[0]
    _vd_err(problems, total == len(rooms),
            f"total shard blocks ({total}) != room_filelist lines "
            f"({len(rooms)}) — the area split would misalign")
    meta = os.path.join(base_dir, "meta", f"area{test_area}_data_label.txt")
    if _vd_err(problems, os.path.isfile(meta),
               f"missing {meta} (room-wise test needs it; note the "
               "reference's own path join is broken — quirk Q6)"):
        listed = [ln.strip() for ln in open(meta) if ln.strip()]
        for rel in listed[:3]:
            _vd_err(problems,
                    os.path.isfile(os.path.join(base_dir, rel)),
                    f"missing room file {os.path.join(base_dir, rel)}")
    pre = os.path.join(base_dir, "Preprocess")
    found = sorted(os.path.basename(p) for p in glob_mats(pre))
    print("  SampIndex .mat files present: " + (", ".join(found) if found
          else "none (the seeded generator will be used — "
               "data/sampling.py:25)"))
    return problems


def run_validate(args) -> None:
    """--validate-data: check the trees, print the exact run commands."""
    any_fail = False
    targets = []
    if args.dataset in ("shapenet", "both"):
        targets.append(("ShapeNet", validate_shapenet_data,
                        os.path.join(args.validate_data, "ShapeNet")))
    if args.dataset in ("s3dis", "both"):
        targets.append(("S3DIS", validate_s3dis_data,
                        os.path.join(args.validate_data, "S3DIS")))
    for name, fn, path in targets:
        # accept both <root>/<Dataset> layout and the dataset dir itself
        if not os.path.isdir(path) and os.path.isdir(args.validate_data):
            probe = args.validate_data
            if name == "ShapeNet" and os.path.isdir(
                    os.path.join(probe, "hdf5_data")):
                path = probe
            elif name == "S3DIS" and os.path.isfile(
                    os.path.join(probe, "all_files.txt")):
                path = probe
        print(f"validating {name} at {path} ...")
        problems = fn(path) if os.path.isdir(path) else [
            f"missing directory {path}"]
        if problems:
            any_fail = True
            print(f"  {name}: {len(problems)} problem(s):")
            for pr in problems:
                print(f"    - {pr}")
        else:
            print(f"  {name}: layout OK")
            if name == "ShapeNet":
                print("  run:\n"
                      f"    python -m weaksuppointcloudseg_tpu.cli."
                      f"train_shapenet --DataPath {path} -m 0.1 -sty Full "
                      f"-bs 32 --Epoch 201 -er 1\n"
                      f"    python -m weaksuppointcloudseg_tpu.cli."
                      f"test_shapenet --DataPath {path} -style Full "
                      f"-dt <stamp printed by training>")
            else:
                print("  run:\n"
                      f"    python -m weaksuppointcloudseg_tpu.cli."
                      f"train_s3dis --DataPath {path} -m 0.1 -sty Full "
                      f"-bs 14 --Epoch 201 -ta 5 -er 1\n"
                      f"    python -m weaksuppointcloudseg_tpu.cli."
                      f"test_s3dis --DataPath {path} -style Full -ta 5 "
                      f"-dt <stamp printed by training>")
    if any_fail:
        raise SystemExit(1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", choices=["shapenet", "s3dis", "both"],
                   default="both")
    p.add_argument("--data-root", default="./Dataset")
    p.add_argument("--validate-data", default=None, metavar="DIR",
                   help="validate an externally-provided dataset tree "
                        "against the expected ShapeNet/S3DIS layouts and "
                        "print the exact reproduction commands, then exit "
                        "(no training). DIR is the data root containing "
                        "ShapeNet/ and/or S3DIS/, or a dataset dir itself.")
    p.add_argument("--m", type=float, default=0.1,
                   help="label fraction (reference headline: 0.1)")
    p.add_argument("--m-grid", action="store_true",
                   help="run the paper's full label-budget grid instead of "
                        "a single --m: ShapeNet m in {0.01, 0.05, 0.1, 1.0} "
                        "(train_ShapeNet.py:32-33), S3DIS m in {0 (one "
                        "labelled point per class — the paper's 1pt "
                        "setting), 0.1} — one train+test run per cell")
    p.add_argument("--smoke", action="store_true",
                   help="synthetic data + tiny epochs (CI smoke)")
    p.add_argument("--smoke-epochs", type=int, default=3)
    p.add_argument("--out", default="reproduction_results.md")
    args = p.parse_args(argv)

    if args.validate_data:
        run_validate(args)
        return

    shapenet_grid = [0.01, 0.05, 0.1, 1.0] if args.m_grid else [None]
    s3dis_grid = [0.0, 0.1] if args.m_grid else [None]
    rows = []
    if args.dataset in ("shapenet", "both"):
        for m in shapenet_grid:
            rows.append(run_shapenet(args, m))
    if args.dataset in ("s3dis", "both"):
        for m in s3dis_grid:
            rows.append(run_s3dis(args, m))

    with open(args.out, "w") as f:
        f.write("# Reproduction results\n\n"
                "Fill-in for the BASELINE.md table — compare against "
                "arXiv:2004.04091 Tab. 2/3 (ShapeNet) and Tab. 4 (S3DIS).\n\n"
                "| dataset | config | metric | value |\n|---|---|---|---|\n")
        for r in rows:
            if "pershape_miou" in r:
                f.write(f"| {r['dataset']} | {r['config']} | per-shape mIoU "
                        f"| {r['pershape_miou']}% |\n")
                f.write(f"| {r['dataset']} | {r['config']} | per-data mIoU "
                        f"| {r['perdata_miou']}% |\n")
            else:
                f.write(f"| {r['dataset']} | {r['config']} | mIoU (13-cls) "
                        f"| {r['miou']}% |\n")
            f.write(f"| {r['dataset']} | {r['config']} | overall acc "
                    f"| {r['acc']}% |\n")
    print(f"wrote {args.out}")
    for r in rows:
        print(" ", r)


if __name__ == "__main__":
    main()
