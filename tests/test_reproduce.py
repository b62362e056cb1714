"""The reproduction runbook (scripts/reproduce.py) must stay executable
end-to-end: synthetic train -> Summary-format check vs the committed
goldens -> LP test -> results table (docs/reproduce.md)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def reproduce_mod():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import reproduce
        yield reproduce
    finally:
        sys.path.pop(0)


def test_smoke_shapenet(reproduce_mod, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reproduce_mod.main([
        "--dataset", "shapenet", "--smoke", "--smoke-epochs", "2",
        "--data-root", str(tmp_path / "Dataset"),
        "--out", str(tmp_path / "results.md")])
    table = open(tmp_path / "results.md").read()
    assert "per-shape mIoU" in table and "overall acc" in table


def test_smoke_s3dis_m_grid(reproduce_mod, tmp_path, monkeypatch):
    """--m-grid runs one train+test per label-budget cell; the S3DIS grid
    covers BOTH weak-label schemes (m=0 one-point-per-class, m=0.1)."""
    monkeypatch.chdir(tmp_path)
    reproduce_mod.main([
        "--dataset", "s3dis", "--m-grid", "--smoke", "--smoke-epochs", "1",
        "--data-root", str(tmp_path / "Dataset"),
        "--out", str(tmp_path / "results.md")])
    table = open(tmp_path / "results.md").read()
    assert "m=0.0 " in table and "m=0.1 " in table


def test_format_signature_rules(reproduce_mod, tmp_path):
    sig = reproduce_mod._line_signature
    # numbers (incl. scientific notation and thousands separators) collapse
    assert sig("Epoch 12 Train loss 2.89 acc 33.20% lr 1.00e-03 "
               "(1,234,567 pts/s)") == sig(
        "Epoch 0 Train loss 0.01 acc 99.99% lr 5.00e-05 (37 pts/s)")
    # structural drift is detected
    assert sig("Epoch 0 Train loss 1.0") != sig("Epoch 0 Eval loss 1.0")
    golden = tmp_path / "golden.txt"
    golden.write_text("# comment ignored\nEpoch 0 Train loss 1.0 acc 5%\n")
    produced = tmp_path / "Summary.txt"
    produced.write_text("Epoch 3 Train loss 2.5 acc 41%\n")
    reproduce_mod.check_summary_format(str(produced), str(golden))  # passes
    produced.write_text("Epoch 3 TrainLoss 2.5 acc 41%\n")
    with pytest.raises(SystemExit, match="drifted"):
        reproduce_mod.check_summary_format(str(produced), str(golden))


def test_validate_data_accepts_synthetic_and_rejects_corrupted(
        reproduce_mod, tmp_path, capsys):
    """--validate-data: the synthetic trees — which the
    loaders demonstrably consume — must validate clean; a corrupted tree
    (missing h5 shard, wrong h5 fields, misaligned room list) must fail
    with named problems so a real-data run elsewhere cannot die on
    plumbing after hours of setup."""
    import shutil

    from weaksuppointcloudseg_tpu.data import s3dis, shapenet

    sn = tmp_path / "ShapeNet"
    s3 = tmp_path / "S3DIS"
    shapenet.write_synthetic(str(sn), num_points=64, train_samples=4,
                             val_samples=2, test_samples=2)
    s3dis.write_synthetic(str(s3), num_rooms_per_area=2, blocks_per_room=2,
                          num_points=64, areas=(1, 5))

    assert reproduce_mod.validate_shapenet_data(str(sn)) == []
    assert reproduce_mod.validate_s3dis_data(str(s3)) == []
    # the CLI wrapper: both OK -> no SystemExit
    reproduce_mod.main(["--validate-data", str(tmp_path)])

    # corrupt ShapeNet: drop a listed shard + break the test file list
    os.remove(str(sn / "hdf5_data" / "ply_data_train0.npz"))
    problems = reproduce_mod.validate_shapenet_data(str(sn))
    assert any("ply_data_train0.npz" in p for p in problems)

    # corrupt S3DIS: room_filelist misaligned with the h5 block count
    with open(s3 / "room_filelist.txt", "a") as f:
        f.write("Area_1_extra_room\n")
    problems = reproduce_mod.validate_s3dis_data(str(s3))
    assert any("room_filelist" in p for p in problems)

    # the CLI wrapper exits nonzero on a broken tree
    with pytest.raises(SystemExit):
        reproduce_mod.main(["--validate-data", str(tmp_path)])
