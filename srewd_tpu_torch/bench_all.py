"""Per-arch sampling benchmark sweep of the port -> one JSON file (twin of
scripts/bench_all.py).

    python -m srewd_tpu_torch.bench_all [-o build/bench_archs_torch.json] [run ...]

Runs `python -m srewd_tpu_torch.bench` for the five architectures at
1000-step DDPM, then sr3 at DDIM-50 and at DPM-25, each in a fresh
subprocess, and writes the collected JSON lines, each with its run's tag
and wall seconds, as an array to `-o` (default build/bench_archs_torch.json,
under the gitignored build/; BENCH_ARCHS.json is the JAX package's record).
Naming runs by tag (sr3, resdiff, ..., sr3-ddim50, sr3-dpm25) runs only
those. BENCH_BATCH / BENCH_T / BENCH_DTYPE / BENCH_REPEATS pass through.
Exits 1 if a run failed; its entry holds the end of its output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "bench_archs_torch.json")
RUNS = [{"BENCH_ARCH": a} for a in ("sr3", "resdiff", "phydiff", "srdiff", "physrdiff")] + [
    {"BENCH_ARCH": "sr3", "BENCH_SAMPLER": "ddim", "BENCH_DDIM_STEPS": "50"},
    {"BENCH_ARCH": "sr3", "BENCH_SAMPLER": "dpm", "BENCH_DDIM_STEPS": "25"},
]


def tag(run: dict) -> str:
    sampler = run.get("BENCH_SAMPLER")
    return run["BENCH_ARCH"] + (f"-{sampler}{run['BENCH_DDIM_STEPS']}" if sampler else "")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.bench_all")
    p.add_argument("-o", "--out", default=OUT)
    p.add_argument("runs", nargs="*", help="run tags to measure (default: all)")
    args = p.parse_args(argv)
    runs = [r for r in RUNS if not args.runs or tag(r) in args.runs]
    if not runs:
        raise SystemExit(f"no runs match {args.runs}; tags: {[tag(r) for r in RUNS]}")
    results = []
    for run in runs:
        print(f"[bench_all] {tag(run)} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "srewd_tpu_torch.bench"],
                           env=dict(os.environ, **run), capture_output=True, text=True,
                           timeout=3600, cwd=REPO)
        entry = {"run": tag(run), "wall_sec": time.perf_counter() - t0}
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            entry["error"] = (r.stderr or r.stdout)[-2000:]
        else:
            entry.update(json.loads(lines[-1]))
        results.append(entry)
        print(f"[bench_all] {json.dumps(entry)}", file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0 if all("error" not in e for e in results) else 1


if __name__ == "__main__":
    sys.exit(main())
