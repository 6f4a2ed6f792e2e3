"""Serve a trained SR diffusion model over HTTP with the port (twin of
scripts/serve.py).

Loads config and checkpoint the way `python -m srewd_tpu_torch.sample`
does, then keeps the sampler warm behind the batching service
(serving/service.py) and its HTTP front end (serving/http.py):

    python -m srewd_tpu_torch.serve -c <cfg>.json -m <checkpoint> --port 8000 \
        [--batch-size 8] [--sampler dpm --ddim-steps 25] [--use-ema] \
        [--device cuda | cuda:0,cuda:1 | cuda:0,cuda:0]

    curl localhost:8000/healthz
    curl localhost:8000/v1/stats
    curl -X POST localhost:8000/v1/super_resolve \
        -d '{"lr": <[n,lh,lw,1] Kelvin nested list>, "months": [1, ...]}'

`--device` takes a comma-separated list of devices, one replica of the
model on each (a card named twice holds two); the default `cuda` is every
visible card, and raises without one. `-m` defaults to the config's
`path.resume_state` (`cli.load_sampling_weights`).
"""

from __future__ import annotations

import argparse


def add_sampler_flags(p: argparse.ArgumentParser) -> None:
    """The sampler flags of the JAX serve and export scripts."""
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm"], default=None)
    p.add_argument("--ddim-steps", type=int, default=None,
                   help="fast-sampler step count (config default: 50); applies even without "
                        "--sampler")
    p.add_argument("--ddim-eta", type=float, default=None,
                   help="DDIM stochasticity (config default: 0.0); applies even without "
                        "--sampler")
    p.add_argument("--spacing", default=None, choices=["linspace", "trailing", "quad", "logsnr"],
                   help="fast-sampler timestep spacing (gaussian.select_taus)")
    p.add_argument("--no-clip-denoised", action="store_true",
                   help="disable the reference's x0 clamp to [-1,1]")


def diffusion_overrides(args) -> dict | None:
    """The flags' model.diffusion overrides, as the JAX scripts merge them."""
    out = {}
    if args.sampler:
        out["sampler"] = args.sampler
    if args.ddim_steps is not None:
        out["ddim_steps"] = args.ddim_steps
    if args.ddim_eta is not None:
        out["ddim_eta"] = args.ddim_eta
    if args.spacing:
        out["tau_spacing"] = args.spacing
    if args.no_clip_denoised:
        out["clip_denoised"] = False
    return out or None


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.serve")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model_path", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--linger-ms", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    add_sampler_flags(p)
    p.add_argument("--device", default="cuda",
                   help="comma-separated devices, one replica each (cuda: every visible card)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    from .serving.http import make_server
    from .serving.service import SamplerService

    args = parse_args(argv)
    service = SamplerService.from_checkpoint(
        args.config, args.model_path, use_ema=args.use_ema,
        diffusion_overrides=diffusion_overrides(args), devices=args.device,
        batch_size=args.batch_size, linger_ms=args.linger_ms, seed=args.seed)
    server = make_server(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(batch {args.batch_size}, replicas on {','.join(map(str, service.devices))})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
