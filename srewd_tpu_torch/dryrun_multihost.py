"""Two-process data-parallel certification on the CPU, the port's twin of
scripts/dryrun_multihost.py:

    python -m srewd_tpu_torch.dryrun_multihost [out.json]

It spawns two ranks that join a gloo process group on localhost, the
environment torchrun gives (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), and a single process. Each rank holds its 4 rows of an 8-row
global batch and takes N_STEPS DiffusionTrainer steps under
DistributedDataParallel (a toy sr3 UNet, dropout 0.1, Adam); the single
process takes the same steps on the whole batch. Then one sampling chain
runs on each rank's rows and is gathered (`all_gather_rows`, the path of
`run_validation`), against the single process's chain on the whole batch.

Checks: the ranks' parameters bit-identical to each other; the ranks' mean
losses, the parameters' digest (the sum of their magnitudes, as the JAX
script's) and the gathered fields within 1e-5 relative of the single
process's. The largest difference of one parameter leaf is reported
beside them: Adam's first steps move a weight by about its learning rate
whatever its gradient's size, so a gradient that float32 rounding leaves
near zero can move it either way. Writes the result as JSON to the path
given (default build/MULTIHOST_torch.json; never the root MULTIHOST.json,
which is the JAX package's) and prints it; exits 1 when a check fails.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_LOCAL, WORLD, H, W = 4, 2, 16, 32
N_STEPS = 3
RTOL = 1e-5  # float32 sums over 4 rows twice against 8 rows once


def _trainer():
    import torch

    from .cli import random_init_
    from .diffusion.schedule import Schedule
    from .models.factory import build_model
    from .training.trainer import DiffusionTrainer

    model = build_model({
        "architecture": "sr3",
        "unet": {"out_channel": 1, "inner_channel": 8, "norm_groups": 4,
                 "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                 "dropout": 0.1},
        "diffusion": {"image_height": H, "image_width": W, "channels": 1},
    })
    random_init_(model.unet, 0)
    sched = Schedule.from_config({"schedule": "linear", "n_timestep": 8,
                                  "linear_start": 1e-4, "linear_end": 2e-2})
    return DiffusionTrainer(model, sched, sched, device=torch.device("cpu"), lr=1e-3, seed=0)


def _global_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"HR": rng.standard_normal((WORLD * B_LOCAL, H, W, 1)).astype(np.float32),
            "LR": rng.standard_normal((WORLD * B_LOCAL, H // 4, W // 4, 1)).astype(np.float32)}


def _run(local) -> dict:
    """The steps and the chain on `local(global batch)`; the losses and
    fields of the global batch, and the parameters."""
    import torch

    from .parallel import all_gather_rows, mean_across

    torch.set_num_threads(1)
    trainer = _trainer()
    losses = [float(mean_across(trainer.train_on_batch_async(local(_global_batch(i)))))
              for i in range(N_STEPS)]
    sr = all_gather_rows(trainer.sample_batch(local(_global_batch(N_STEPS))))
    params = {k: v.numpy() for k, v in trainer.model.unet.state_dict().items()}
    return {"losses": losses, "sr": sr.numpy(), "params": params}


def _digest(params: dict) -> float:
    return float(sum(np.abs(v.astype(np.float64)).sum() for v in params.values()))


def worker_main(out: str) -> None:
    from .parallel import init_distributed, rank, rows, shutdown, world_size

    init_distributed("gloo")
    try:
        if world_size() != WORLD:
            raise RuntimeError(f"expected {WORLD} ranks, got {world_size()}")
        res = _run(lambda b: {k: v[rows(B_LOCAL)] for k, v in b.items()})
        np.savez(f"{out}.rank{rank()}.npz", losses=res["losses"], sr=res["sr"],
                 **{"p/" + k: v for k, v in res["params"].items()})
    finally:
        shutdown()


def single_main(out: str) -> None:
    res = _run(lambda b: b)
    np.savez(f"{out}.single.npz", losses=res["losses"], sr=res["sr"],
             **{"p/" + k: v for k, v in res["params"].items()})


def _load(path: str) -> dict:
    with np.load(path) as z:
        return {"losses": z["losses"], "sr": z["sr"],
                "params": {k[2:]: z[k] for k in z.files if k.startswith("p/")}}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def coordinator_main(out_path: str | None = None) -> dict:
    out_path = os.path.abspath(out_path or os.path.join(REPO, "build", "MULTIHOST_torch.json"))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with socket.socket() as s:  # a free localhost port for the rendezvous
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    stem = out_path + ".parts"
    cmd = [sys.executable, "-m", "srewd_tpu_torch.dryrun_multihost"]
    procs = []
    for r in range(WORLD):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(WORLD),
               "MASTER_ADDR": "localhost", "MASTER_PORT": port}
        procs.append(subprocess.Popen([*cmd, "worker", stem], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    single = subprocess.run([*cmd, "single", stem], cwd=REPO, env=env, capture_output=True,
                            text=True, timeout=600)
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"rank {r} failed (rc={p.returncode}):\n{o[-4000:]}")
    if single.returncode != 0:
        raise SystemExit(f"the single process failed:\n{single.stderr[-4000:]}")

    ranks = [_load(f"{stem}.rank{r}.npz") for r in range(WORLD)]
    ref = _load(f"{stem}.single.npz")
    for path in [f"{stem}.rank{r}.npz" for r in range(WORLD)] + [f"{stem}.single.npz"]:
        os.unlink(path)
    r0 = ranks[0]
    ranks_agree = all(
        np.array_equal(r["params"][k], r0["params"][k]) for r in ranks[1:] for k in r0["params"]
    ) and all(np.array_equal(r["losses"], r0["losses"]) and np.array_equal(r["sr"], r0["sr"])
              for r in ranks[1:])
    loss_rel = _rel(r0["losses"], ref["losses"])
    params_rel = max(_rel(r0["params"][k], v) for k, v in ref["params"].items())
    digest_rel = abs(_digest(r0["params"]) - _digest(ref["params"])) / _digest(ref["params"])
    sample_rel = _rel(r0["sr"], ref["sr"])
    result = {
        "ok": bool(ranks_agree and loss_rel <= RTOL and digest_rel <= RTOL
                   and sample_rel <= RTOL
                   and r0["sr"].shape == (WORLD * B_LOCAL, H, W, 1)
                   and np.isfinite(r0["sr"]).all()),
        "n_processes": WORLD, "backend": "gloo", "batch_per_process": B_LOCAL,
        "steps": N_STEPS, "rtol": RTOL,
        "losses_multiprocess": [float(x) for x in r0["losses"]],
        "losses_single": [float(x) for x in ref["losses"]],
        "param_digest_multiprocess": _digest(r0["params"]),
        "param_digest_single": _digest(ref["params"]),
        "ranks_agree": bool(ranks_agree), "loss_max_rel": loss_rel,
        "param_digest_rel": digest_rel, "param_max_rel": params_rel,
        "sample_max_rel": sample_rel,
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["worker"]:
        worker_main(argv[1])
    elif argv[:1] == ["single"]:
        single_main(argv[1])
    elif len(argv) <= 1:
        sys.exit(0 if coordinator_main(argv[0] if argv else None)["ok"] else 1)
    else:
        sys.exit(f"usage: python -m srewd_tpu_torch.dryrun_multihost [out.json]; got {argv}")
