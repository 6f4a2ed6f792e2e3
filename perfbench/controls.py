"""The readings a cell's limits are set from, on the chip at the cell's own
size, in one process (so set-up is paid once): for each seed the numbers
the program's run compares (`--program-seconds`, a short window at the
cell's own load) and those of the control, the plain reference one
precision below the cell's (float32 -> TF32, bf16 -> scaled fp8; see
reference/numerics.py) put in the program's place. One JSON line each,
beside the cell's limits.

    python3 -m perfbench.controls --workload <cell> --seeds 11,12,13 [--program-seconds 5]
        [--control-seeds 11,12]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import cell as cells
from perfbench.run import _cache_dirs

MODE = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program-seconds", type=float, default=0.0)
    p.add_argument("--control-seeds", default=None, help="default: --seeds")
    p.add_argument("--fault", default=None,
                   help="also read this fault (training: half_batch) beside the control")
    args = p.parse_args(argv)
    _cache_dirs()
    c = cells.find(args.workload)
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    mode = MODE[c.traffic["dtype"]]
    lim = c.limits["checks"]
    seeds = [int(s) for s in args.seeds.split(",")]
    control = seeds if args.control_seeds is None else [
        int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + [s for s in control if s not in seeds]:
        if args.program_seconds > 0 and seed in seeds:
            out = c.driver.run(c, seed=seed, seconds=args.program_seconds, trace=False,
                               device=device)
            print(json.dumps({"workload": c.name, "seed": seed, "side": "program",
                              **{n: v for n, v, _ in out.checks}, "failed": out.failed,
                              "attempted": out.attempted, **out.extra, "limits": lim}),
                  flush=True)
        if seed in control:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            if c.traffic["driver"] == "train":  # the train CLI's cuDNN choices
                torch.backends.cudnn.deterministic = True
                torch.backends.cudnn.benchmark = True
            for fault in [None] + ([args.fault] if args.fault else []):
                kw = {"fault": fault} if fault else {}
                got = c.driver.control(c, seed=seed, device=device, mode=mode, **kw)
                side = f"fault-{fault}" if fault else f"control-{mode}"
                print(json.dumps({"workload": c.name, "seed": seed, "side": side,
                                  **got, "limits": lim,
                                  "fails": sorted(k for k in lim if got[k] > lim[k])}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
