"""On-device shape-robustness sweep: one train step + sync per config.

Each case runs in its own SUBPROCESS, one at a time (never two processes
on one card), so a backend fault (a crash, not a Python exception) fails
only that case and the sweep continues. The grid covers both presets
(the S3DIS model differs structurally: 9-channel input, graph on
channels 6:9, smooth on 0:6, 512-wide head, no transform net) and the
inference paths (eval forward + every LP solver) at odd N. Extend CASES
when adding kernels or supported shapes; run on the card:

    python scripts/shape_sweep.py
"""
import sys, subprocess

CASES = []
for dtype in ("float32", "bfloat16"):
    for bs, n, k in [(4, 512, 13), (8, 1024, 13), (16, 1024, 50),
                     (8, 4096, 13), (16, 2048, 50), (4, 3000, 50)]:
        CASES.append(("train", dtype, bs, n, k))
# the S3DIS preset differs structurally (9-channel input, kNN graph on
# channels 6:9, smooth on 0:6, 512-wide head, no transform net)
for dtype, bs, n in [("bfloat16", 14, 4096), ("float32", 4, 1024),
                     ("bfloat16", 2, 3000), ("bfloat16", 1, 1500)]:
    CASES.append(("s3dis", dtype, bs, n, 13))
# inference paths: every LP solver and the eval forward at odd N
for solver, n in [("solve", 1234), ("cg", 1234), ("cg_matfree", 1234),
                  ("solve", 3000), ("cg_matfree", 5000)]:
    CASES.append(("lp", solver, 2, n, 50))
for dtype, n in [("bfloat16", 1500), ("bfloat16", 3000),
                 ("float32", 1234), ("bfloat16", 777)]:
    CASES.append(("fwd", dtype, 4, n, 50))
# static-graph mode (ModelConfig.static_graph) at odd N
CASES += [
    ("train_sg", "bfloat16", 4, 3000, 50),
    ("train_sg", "bfloat16", 8, 1024, 13),
    ("train_sg", "float32", 4, 1024, 13),
    ("s3dis_sg", "bfloat16", 2, 3000, 13),
    ("fwd_sg", "bfloat16", 4, 3000, 50),
    ("fwd_sg", "bfloat16", 4, 777, 50),
]

if len(sys.argv) > 1:
    kind, dtype, bs, n, k = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                             int(sys.argv[4]), int(sys.argv[5]))
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import dataclasses
    import numpy as np, jax
    from weaksuppointcloudseg_tpu import configs
    from weaksuppointcloudseg_tpu.train.state import create_train_state
    from weaksuppointcloudseg_tpu.train.steps import make_train_step
    from weaksuppointcloudseg_tpu.utils.tools import onehot_encode

    if kind == "lp":
        import jax.numpy as jnp
        from weaksuppointcloudseg_tpu.propagate.label_prop import (
            propagate_batch,
        )

        rng = np.random.default_rng(0)
        xyz = rng.standard_normal((bs, n, 3)).astype(np.float32)
        xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True).max(
            1, keepdims=True)
        g = jax.nn.softmax(
            jnp.asarray(rng.standard_normal((bs, n, k)), jnp.float32), -1)
        y = propagate_batch(jax.device_put(xyz), jax.device_put(g),
                            solver=dtype)
        assert np.isfinite(float(jnp.sum(y)))
        print(f"PASS lp {dtype} N={n}")
        sys.exit(0)

    static_graph = kind.endswith("_sg")
    kind = kind[:-3] if static_graph else kind
    cfg = (configs.s3dis_config() if kind == "s3dis"
           else configs.shapenet_config())
    model_kw = dict(num_points=n, num_classes=k, compute_dtype=dtype,
                    static_graph=static_graph)
    if kind != "s3dis":
        model_kw["num_categories"] = 4
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, batch_size=bs, style="Full"),
    )
    cin = cfg.model.in_channels
    rng = np.random.default_rng(0)
    seg = rng.integers(0, k, (2 * bs, n)).astype(np.int32)
    batch = jax.device_put({
        "data": rng.standard_normal((2 * bs, n, cin)).astype(np.float32),
        "seg": seg, "seg_onehot": onehot_encode(seg, k),
        "mask": (rng.uniform(size=seg.shape) < 0.2).astype(np.float32),
        "cat_onehot": onehot_encode(rng.integers(0, 4, (2 * bs,)), 4),
        "valid": np.ones((2 * bs,), np.float32),
    })
    state = create_train_state(jax.random.PRNGKey(0), cfg)
    if kind == "fwd":
        from weaksuppointcloudseg_tpu.train.steps import make_eval_step

        ev = make_eval_step(cfg)
        vb = {kk: batch[kk] for kk in
              ("data", "seg_onehot", "mask", "cat_onehot") if kk in batch}
        prob, loss = ev(state, vb)
        assert np.isfinite(float(loss))
        print(f"PASS fwd {dtype} N={n} loss={float(loss):.3f}")
        sys.exit(0)
    step = make_train_step(cfg)
    key = jax.random.key(1, impl=cfg.train.rng_impl)
    state, metrics = step(state, batch, np.float32(1.0), key)
    tot = float(metrics["total"])
    assert np.isfinite(tot), f"non-finite loss {tot}"
    print(f"PASS {kind} {dtype} bs={bs} N={n} K={k} loss={tot:.3f}")
    sys.exit(0)

import os
env = dict(os.environ)
fails = 0
for c in CASES:
    try:
        r = subprocess.run(
            [sys.executable, __file__, *map(str, c)],
            capture_output=True, text=True, timeout=900, env=env)
    except subprocess.TimeoutExpired:
        # a hung (not crashed) case must fail only itself
        fails += 1
        print(f"FAIL {c}: timeout (hung worker?)", flush=True)
        continue
    line = [l for l in r.stdout.splitlines() if l.startswith("PASS")]
    if r.returncode == 0 and line:
        print(line[0], flush=True)
    else:
        fails += 1
        print(f"FAIL {c}: rc={r.returncode}", flush=True)
        print((r.stderr or "")[-800:], flush=True)
print("sweep done,", fails, "failures")
