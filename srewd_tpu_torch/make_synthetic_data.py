"""Write a synthetic WeatherBench npy tree for demos, benches and tests
(twin of scripts/make_synthetic_data.py):

    python -m srewd_tpu_torch.make_synthetic_data --root data \
        --min-date 2017-01-01-00 --max-date 2017-02-01-00 [--lr 32 64] [--hr 128 256]

LR is the exact 4x block mean of HR (data/store.py make_synthetic_weatherbench).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.make_synthetic_data")
    p.add_argument("--root", default="srewd_data")
    p.add_argument("--min-date", default="2017-01-01-00")
    p.add_argument("--max-date", default="2017-02-01-00")
    p.add_argument("--lr", type=int, nargs=2, default=(32, 64))
    p.add_argument("--hr", type=int, nargs=2, default=(128, 256))
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> str:
    from .data.store import make_synthetic_weatherbench

    args = parse_args(argv)
    root = make_synthetic_weatherbench(args.root, args.min_date, args.max_date,
                                       lr_shape=tuple(args.lr), hr_shape=tuple(args.hr),
                                       seed=args.seed)
    print(f"wrote synthetic WeatherBench tree at {root}")
    return root


if __name__ == "__main__":
    main()
