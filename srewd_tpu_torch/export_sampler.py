"""Export a trained SR sampler as one self-contained artifact with the port
(twin of scripts/export_sampler.py).

Loads config and checkpoint the way `python -m srewd_tpu_torch.serve`
does, then writes the conditioning and step programs, the weights, the
chain's constants and the Kelvin scalers into one file
(serving/export.py):

    python -m srewd_tpu_torch.export_sampler -c <cfg>.json -m <checkpoint> \
        -o model.srexport [--use-ema] [--sampler dpm --ddim-steps 25] \
        [--static-batch N] [--device cuda]

Serving then needs torch, numpy, srewd_tpu_torch.ops and the artifact:

    from srewd_tpu_torch.serving.export import load_sampler
    fn = load_sampler("model.srexport")
    sr_kelvin = fn(lr_kelvin, months, seed=0)

Export on the device you will serve on (`--device`, the card by default).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .serve import add_sampler_flags, diffusion_overrides


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.export_sampler")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model_path", default=None)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--static-batch", type=int, default=None,
                   help="export for ONE fixed batch size instead of the default symbolic "
                        "batch dimension")
    add_sampler_flags(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from .serving.export import export_sampler, save_sampler
    from .serving.service import load_stack

    args = parse_args(argv)
    stack = load_stack(args.config, args.model_path, args.use_ema, diffusion_overrides(args),
                       device=args.device)
    t0 = time.perf_counter()
    exported = export_sampler(
        stack.model, stack.model.params(), stack.schedule, stack.lr_shape,
        sampler_kwargs=stack.sampler_kwargs, lr_scaler=stack.lr_scaler,
        hr_scaler=stack.hr_scaler, symbolic_batch=args.static_batch is None,
        batch_size=args.static_batch or 8)
    export_sec = time.perf_counter() - t0
    save_sampler(exported, args.out)
    out = {"out": args.out, "mb": os.path.getsize(args.out) / 1e6, "export_sec": export_sec,
           **exported.header}
    print("EXPORT OK " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
