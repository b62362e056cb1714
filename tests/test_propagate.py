"""Label propagation / Laplacian tests vs. straight numpy math.

The numpy oracles re-derive the reference formulas (Util/Tool.py:435-467,
Util/ProbLabelPropagation.py:21-42) independently: explicit inverse, explicit
diagonal matrices — exactly the construction the library avoids.
"""

import numpy as np
import pytest

from weaksuppointcloudseg_tpu.propagate import (
    laplacian_xyz_rgb,
    product_kernel_weights,
    entropy_confidence,
    label_propagation,
    propagate_batch,
)


def np_sqdist(x):
    n = x.shape[0]
    d = np.sum(x**2, 1)[:, None] + np.sum(x**2, 1)[None, :] - 2 * x @ x.T
    return np.maximum(d, 0.0)


def np_laplacian(xyz, rgb, sym=True, bw_xyz=1e3, bw_rgb=1e1):
    w = np.exp(-np_sqdist(xyz) * bw_xyz) * np.exp(-np_sqdist(rgb) * bw_rgb)
    d = w.sum(-1)
    lap = np.diag(d + 1e-8) - w
    if sym:
        dn = np.diag(d**-0.5)
        lap = dn @ lap @ dn
    return lap


def np_label_prop(lap, g, alpha=1.0, beta=1.0):
    n, k = g.shape
    entropy = -np.sum(g * np.log2(g + 1e-5), axis=1)
    w = 1.0 - entropy / np.log2(k)
    y = beta * np.linalg.inv(alpha * lap + beta * np.diag(w) + 1e-5 * np.eye(n)) @ np.diag(w) @ g
    return y, y / y.sum(-1, keepdims=True), w


@pytest.fixture
def cloud(rng):
    b, n = 2, 48
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32) * 0.3
    rgb = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    logits = rng.standard_normal((b, n, 5)).astype(np.float32) * 2
    g = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return xyz, rgb, g


def test_laplacian_matches_numpy(cloud):
    xyz, rgb, _ = cloud
    for sym in (True, False):
        got = np.asarray(laplacian_xyz_rgb(xyz, rgb, sym=sym))
        for b in range(xyz.shape[0]):
            want = np_laplacian(xyz[b], rgb[b], sym=sym)
            np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-5)


def test_weights_symmetric_nonneg(cloud):
    xyz, rgb, _ = cloud
    w = np.asarray(product_kernel_weights(xyz, rgb))
    assert (w >= 0).all() and (w <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(w, np.swapaxes(w, 1, 2), atol=1e-5)


def test_entropy_confidence(cloud):
    _, _, g = cloud
    got = np.asarray(entropy_confidence(g))
    k = g.shape[-1]
    want = 1.0 - (-np.sum(g * np.log2(g + 1e-5), -1)) / np.log2(k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # one-hot rows -> confidence ~1; uniform rows -> ~0
    onehot = np.zeros((1, 4, k), np.float32)
    onehot[..., 0] = 1.0
    assert np.asarray(entropy_confidence(onehot)).min() > 0.99
    uniform = np.full((1, 4, k), 1.0 / k, np.float32)
    assert np.abs(np.asarray(entropy_confidence(uniform))).max() < 1e-3


def test_label_prop_matches_inverse_oracle(cloud):
    xyz, rgb, g = cloud
    lap = np.asarray(laplacian_xyz_rgb(xyz, rgb, sym=True))
    y, y_prob, w = label_propagation(lap, g)
    for b in range(g.shape[0]):
        y_np, y_prob_np, w_np = np_label_prop(lap[b], g[b])
        np.testing.assert_allclose(np.asarray(w)[b], w_np, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(y)[b], y_np, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(np.asarray(y_prob)[b], y_prob_np, rtol=1e-3, atol=1e-5)


def test_label_prop_cg_close_to_dense(cloud):
    xyz, rgb, g = cloud
    lap = np.asarray(laplacian_xyz_rgb(xyz, rgb, sym=True))
    _, dense, _ = label_propagation(lap, g, solver="solve")
    _, cg, _ = label_propagation(lap, g, solver="cg", cg_iters=200)
    np.testing.assert_allclose(np.asarray(cg), np.asarray(dense), rtol=1e-2, atol=1e-3)


def test_factored_cg_matches_solve_at_production_config(cloud):
    """The SHIPPED default (solver="cg" = factored-W, cg_iters=50,
    tol 1e-5 — configs.LabelPropConfig) must agree with the dense-LU
    oracle path at the production iteration cap: CG's tol-based early
    exit (~12 iterations at the ShapeNet test shape) is an optimization,
    not an accuracy trade. Probabilities to 1e-3, argmax everywhere."""
    from weaksuppointcloudseg_tpu.configs import LabelPropConfig

    lp = LabelPropConfig()
    assert lp.solver == "cg"  # the benched config IS the shipped default
    xyz, rgb, g = cloud
    dense = np.asarray(propagate_batch(xyz, g, rgb, solver="solve"))
    cg = np.asarray(propagate_batch(
        xyz, g, rgb, solver=lp.solver, cg_iters=lp.cg_iters,
        cg_tol=lp.cg_tol))
    np.testing.assert_allclose(cg, dense, rtol=1e-2, atol=1e-3)
    assert (cg.argmax(-1) == dense.argmax(-1)).all()
    # ShapeNet variant (rgb=None -> xyz doubles as color, Tool.py:451)
    dense2 = np.asarray(propagate_batch(xyz, g, solver="solve"))
    cg2 = np.asarray(propagate_batch(
        xyz, g, solver=lp.solver, cg_iters=lp.cg_iters, cg_tol=lp.cg_tol))
    np.testing.assert_allclose(cg2, dense2, rtol=1e-2, atol=1e-3)
    assert (cg2.argmax(-1) == dense2.argmax(-1)).all()


def test_propagate_batch_end_to_end(cloud):
    xyz, rgb, g = cloud
    out = np.asarray(propagate_batch(xyz, g, rgb))
    assert out.shape == g.shape
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)
    # xyz-only variant (ShapeNet) runs too
    out2 = np.asarray(propagate_batch(xyz, g))
    assert out2.shape == g.shape


def test_label_prop_confident_input_stays(cloud):
    """Highly confident predictions should barely move."""
    xyz, rgb, _ = cloud
    b, n, _ = xyz.shape
    k = 5
    labels = np.random.default_rng(1).integers(0, k, (b, n))
    g = np.full((b, n, k), 1e-4, np.float32)
    g[np.arange(b)[:, None], np.arange(n)[None, :], labels] = 1 - 1e-4 * (k - 1)
    out = np.asarray(propagate_batch(xyz, g, rgb))
    assert (out.argmax(-1) == labels).mean() > 0.95


def test_room_lp_beats_per_block_on_cross_block_structure():
    """The accuracy case for --RoomLP: objects
    straddling block boundaries whose confident predictions sit on one
    side. Per-block LP (the reference's semantics,
    S3DIS_DGCNN_trainer.py:539-556) cannot repair the corrupted half —
    room-level LP propagates across the boundary. Full 5-seed table:
    scripts/roomlp_ab.py (mean none=0.716, block=0.778, room=1.000)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import roomlp_ab

    rng = np.random.default_rng(0)
    res = roomlp_ab.run_modes(*roomlp_ab.make_room(rng))
    assert res["room"] > res["block"] + 0.1
    assert res["room"] > res["none"] + 0.1


@pytest.mark.parametrize("with_rgb", [False, True], ids=["xyz", "xyzrgb"])
@pytest.mark.parametrize("n,row_tile", [(60, 16), (97, 32), (150, 64)])
def test_matfree_matches_dense_solve_when_tiles_do_not_divide(
        rng, n, row_tile, with_rgb):
    """Matrix-free CG (affinity rows recomputed per tile) against the
    dense LU solve, at point counts the row tile does not divide (a
    prime N falls back to one-row tiles)."""
    from weaksuppointcloudseg_tpu.propagate.label_prop import (
        label_propagation_matfree,
    )

    b, k = 2, 5
    # ~0.04 between neighbours: exp(-1e3 d^2) couples each point to a few
    xyz = rng.uniform(0, 0.2, (b, n, 3)).astype(np.float32)
    rgb = (rng.uniform(0, 1, (b, n, 3)).astype(np.float32) if with_rgb
           else xyz)
    logits = rng.standard_normal((b, n, k)).astype(np.float32) * 2
    g = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    dense = np.asarray(propagate_batch(xyz, g, rgb, solver="solve"))
    got = np.asarray(label_propagation_matfree(
        xyz, g, rgb, row_tile=row_tile, cg_iters=200))
    np.testing.assert_allclose(got, dense, rtol=1e-2, atol=1e-3)
    assert (got.argmax(-1) == dense.argmax(-1)).mean() >= 0.99
