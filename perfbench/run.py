"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It builds the cell's system from BENCHMARK.json's entries
(`perfbench/cell.py`), makes every input from the seed, warms up, measures
for `--seconds`, checks what the timed path produced against the plain
reference (`perfbench/reference/`), and prints, as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics; with `--trace 1` its per-layer ones), `device`,
`breakdown` (with `--trace 1`) and `checks`, each number compared beside
its limit, which are also the last lines of standard error. Exit codes:
0 a result was printed; 2 the checkout lacks the program or BENCHMARK.json;
3 no card, or fewer than the cell asks for; 4 jax or the JAX package was
loaded; 1 anything else.
"""

from __future__ import annotations

import time

_T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "srewd_tpu")


def _cache_dirs() -> None:
    """Every compile cache at a fixed path inside the checkout, set before
    torch or CUDA starts: the port's nvcc libraries build into
    build/srewd_tpu_torch/ by themselves (ops/_build.py)."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("WANDB_MODE", "disabled")


def forbidden_modules() -> list:
    """The top-level names of loaded modules that are jax or the JAX
    package, compared whole (srewd_tpu_torch is not srewd_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    missing = [x for x in ("BENCHMARK.json", "srewd_tpu_torch") if
               not os.path.exists(os.path.join(ROOT, x))]
    if missing:
        print(f"perfbench: the checkout lacks {missing}", file=sys.stderr)
        return 2
    _cache_dirs()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from perfbench import cell as cells
    from perfbench import report

    c = cells.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {c.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    out = c.driver.run(c, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                       device=device)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad} in the measuring process", file=sys.stderr)
        return 4
    line = report.result(c, out, setup_s=out.window_start - _T_PROCESS, trace=bool(args.trace),
                         device=device)
    if out.extra:
        print(f"perfbench: {json.dumps(out.extra)}", file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
