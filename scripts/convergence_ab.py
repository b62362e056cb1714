"""Multi-seed convergence A/B for the accuracy-affecting config choices.

Puts statistical footing under two decisions:

- bf16 vs f32 compute — whether bf16 training converges like the f32
  reference-parity preset;
- static-graph turbo (ModelConfig.static_graph) vs the default dynamic
  feature-space graphs — decides whether static_graph stays opt-in.

Each run executes in its own SUBPROCESS, one at a time (never two on one
card), so a backend fault fails only that run. Results go to stdout as a
table and to --out as JSON:

    python scripts/convergence_ab.py --seeds 5 --out ab.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (family, compute_dtype, static_graph)
CONFIGS = {
    "shapenet_bf16": ("shapenet", "bfloat16", False),
    "shapenet_f32": ("shapenet", "float32", False),
    "shapenet_static": ("shapenet", "bfloat16", True),
    "s3dis_bf16": ("s3dis", "bfloat16", False),
    "s3dis_static": ("s3dis", "bfloat16", True),
}


def run_one(name: str, seed: int, epochs: int,
            data_seed: int | None = 0, eval_tail: int = 1) -> float:
    family, dtype, static = CONFIGS[name]
    sys.path.insert(0, REPO)
    from weaksuppointcloudseg_tpu.utils import synth_convergence as sc

    if family == "shapenet":
        # data_seed pinned (default 0, a verified-learnable draw): config
        # A/Bs vary only training stochasticity, so the paired differences
        # measure the config, not dataset difficulty (a coupled-seed band
        # is dominated by draws on which every config half-converges;
        # docs/kernels.md). Pass --data-seed -1 to couple them again.
        miou = sc.shapenet_train_and_eval_miou(
            dtype, seed=seed, epochs=epochs, static_graph=static,
            data_seed=data_seed, eval_tail=eval_tail)
    else:
        # the S3DIS recipe always used a fixed synthetic set (seed=0 in
        # write_synthetic) — already decoupled, hence its 7x tighter band
        miou, _acc = sc.s3dis_train_and_eval_miou(
            dtype, seed=seed, epochs=epochs, static_graph=static)
    print(f"RESULT {name} seed={seed} miou={miou:.4f}", flush=True)
    return miou


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--configs", nargs="*", default=list(CONFIGS),
                   choices=list(CONFIGS))
    p.add_argument("--out", default="convergence_ab.json")
    p.add_argument("--data-seed", type=int, default=0,
                   help="ShapeNet dataset draw (-1: couple to the training "
                        "seed)")
    p.add_argument("--eval-tail", type=int, default=1,
                   help="average ShapeNet val mIoU over the final K "
                        "epochs (K>1 kills final-checkpoint plateau "
                        "jitter; requires a pinned --data-seed)")
    p.add_argument("--one", nargs=2, metavar=("CONFIG", "SEED"),
                   help="internal: run a single case in-process")
    args = p.parse_args()
    data_seed = None if args.data_seed < 0 else args.data_seed

    if args.one:
        run_one(args.one[0], int(args.one[1]), args.epochs, data_seed,
                args.eval_tail)
        return

    results: dict = {c: {} for c in args.configs}
    for name in args.configs:
        for seed in range(args.seeds):
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--epochs", str(args.epochs),
                   "--data-seed", str(args.data_seed),
                   "--eval-tail", str(args.eval_tail),
                   "--one", name, str(seed)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=1800, env=dict(os.environ))
            except subprocess.TimeoutExpired:
                print(f"FAIL {name} seed={seed}: timeout", flush=True)
                results[name][seed] = None
                continue
            line = [l for l in r.stdout.splitlines()
                    if l.startswith("RESULT")]
            if r.returncode == 0 and line:
                miou = float(line[0].rsplit("=", 1)[1])
                results[name][seed] = miou
                print(line[0], flush=True)
            else:
                results[name][seed] = None
                print(f"FAIL {name} seed={seed}: rc={r.returncode}\n"
                      f"{(r.stderr or '')[-600:]}", flush=True)

    print("\n== summary (val mIoU over seeds) ==")
    summary = {}
    for name, per_seed in results.items():
        vals = [v for v in per_seed.values() if v is not None]
        if not vals:
            print(f"  {name:<18} ALL FAILED")
            continue
        mean = statistics.mean(vals)
        sd = statistics.stdev(vals) if len(vals) > 1 else 0.0
        summary[name] = {"mean": mean, "sd": sd, "min": min(vals),
                         "max": max(vals), "n": len(vals),
                         "per_seed": per_seed}
        print(f"  {name:<18} mean {mean:.3f}  sd {sd:.3f}  "
              f"min {min(vals):.3f}  max {max(vals):.3f}  n={len(vals)}")
    with open(args.out, "w") as f:
        json.dump({"epochs": args.epochs, "summary": summary}, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
