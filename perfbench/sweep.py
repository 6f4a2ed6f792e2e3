"""Find the serving cell's knee: the open loop at several offered rates
in one process, each printed as a JSON line (p50 and p95 latency, served
fields/s, how late the submitter ran, and `latency_trend`, the mean
latency of the last fifth of requests over the first fifth: above about
1.5 the backlog grows).

    python3 -m perfbench.sweep --workload phydiff-serve-bf16 --seed <n> --seconds 20 \
        --rates 16,20,24,28
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import cell as cells
from perfbench.run import _cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    _cache_dirs()
    c = cells.find(args.workload)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    for rate in (float(r) for r in args.rates.split(",")):
        out = c.driver.run(c, seed=args.seed, seconds=args.seconds, trace=False,
                           device=torch.device("cuda", 0), rate=rate, check=False)
        print(json.dumps({"rate_fields_per_s": rate, **out.metrics, "failed": out.failed,
                          **out.extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
