"""The port's data parallelism on the CPU: gloo ranks in spawned processes.

Two ranks are spawned once for the module (`ranks`). They run every
rank-side case (`_rank_cases`) while this process computes the references
of one process at the global batch; then each test compares:
  * the draws: the rank-r rows of a 2-rank draw are rows [r B, (r + 1) B)
    of the one-process draw at 2 B (gamma's uniforms, the training noise,
    the chain noise, the dropout masks), t is one draw for the global
    batch, and the ranks' losses average to the one-process loss; at world
    size 1 the draws are the plain ones a single process always drew;
  * `run_training` on two ranks (each its stride of a synthetic tree, local
    batch 2, dropout 0.2) against one process at batch 4 on the same global
    batches: losses and parameters, the gathered validation's metrics, and
    one bf16 step;
  * rank 0 alone writes the checkpoints, and two ranks resumed from the
    step-2 checkpoint (inside an epoch) repeat the uninterrupted run's
    steps 3 and 4;
  * the entry points: `python -m torch.distributed.run --nproc_per_node=2 -m
    srewd_tpu_torch.train --device cpu` and `... pretrain`, and `python -m
    srewd_tpu_torch.dryrun_multihost`.

This module imports no JAX, so a spawned rank starts fast; the comparison
with the JAX package is tests/test_torch_port_ddp_jax.py, whose ranks run
`rank_jax_slice` below. Toy widths (inner 16, 8 groups, mults (1, 2, 4),
one res block, attention at 8x16) over 32x64 fields, one torch thread.
"""

import copy
import functools
import glob
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer, random_init_
from srewd_tpu_torch.configs.config import load_commented_json
from srewd_tpu_torch.data.device_cache import DeviceDataset
from srewd_tpu_torch.data.store import make_synthetic_weatherbench
from srewd_tpu_torch.diffusion.gaussian import chain_plan, draw_time_and_gamma, run_chain
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import DiffusionModel, build_model
from srewd_tpu_torch.models.layers import Dropout
from srewd_tpu_torch.parallel import (
    draw_rows, init_distributed, local_device, mean_across, rank, rows, shutdown, world_size)
from srewd_tpu_torch.training.checkpoint import CheckpointManager
from srewd_tpu_torch.training.trainer import DiffusionTrainer, run_training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B, H, W = 2, 2, 32, 64
SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
SCHED8 = {"schedule": "linear", "n_timestep": 8, "linear_start": 1e-4, "linear_end": 2e-2}
RTOL = 1e-5  # float32 sums over 2 rows twice against 4 rows once
# the validation's metrics after 4 steps: SSIM (0.13 here) is a ratio of
# covariances of fields that the steps' float32 differences reach
VAL_RTOL = 1e-4
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative, at the top of its binade
TOY_UNET = {"in_channel": 2, "out_channel": 1, "inner_channel": 16, "norm_groups": 8,
            "channel_multiplier": [1, 2, 4], "attn_res": [8], "res_blocks": 1}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_cfg(arch="phydiff", dropout=0.2):
    return {"architecture": arch, "unet": {**TOY_UNET, "dropout": dropout},
            "diffusion": {"image_height": H, "image_width": W, "image_channels": 1,
                          "channels": 1, "conditional": True}}


def global_batch(seed, n=WORLD * B):
    rng = np.random.default_rng(seed)
    return {"HR": rng.standard_normal((n, H, W, 1)).astype(np.float32),
            "LR": rng.standard_normal((n, H // 4, W // 4, 1)).astype(np.float32)}


def rel(got, want):
    """Largest difference over the largest magnitude of `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def norm_rel(got, want):
    """|got - want| / |want| (Frobenius): one leaf's relative difference.
    Adam moves every weight by about its learning rate whatever its
    gradient's size, so the few elements whose gradient float32 rounding
    leaves near zero differ by more than rounding; the leaf's norm does not."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------------- spawning
def _rank_entry(r, world, port, fn, args):
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    init_distributed("gloo")
    try:
        fn(*args)
    finally:
        shutdown()


def start_ranks(fn, *args, world=WORLD):
    """`fn(*args)` in `world` spawned processes joined in a gloo group by
    torchrun's environment variables; join them with `join_ranks`."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, port, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, timeout=300):
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, "a rank did not finish in time"
    assert [p.exitcode for p in procs] == [0] * len(procs), [p.exitcode for p in procs]


class GlobalHandler:
    """The ranks' DataHandlers seen as one process: each batch holds rank 0's
    rows, then rank 1's (the global batch DDP trains on)."""

    def __init__(self, parts):
        self.parts = parts

    def steps_per_epoch(self, split="train"):
        return self.parts[0].steps_per_epoch(split)

    def train_batches(self, epoch=0, skip=0):
        return self._cat(p.train_batches(epoch=epoch, skip=skip) for p in self.parts)

    def val_batches(self):
        return self._cat(p.val_batches() for p in self.parts)

    def inverse_transform(self, data, months):
        return self.parts[0].inverse_transform(data, months)

    @staticmethod
    def _cat(streams):
        for bs in zip(*streams):
            yield {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}


# ----------------------------------------------------------------- rank side
def _draws(n=B):
    """Every draw of the training step and the chain at batch n on this
    process: a rank's n = B rows, or one process's n = WORLD x B."""
    out = {}
    g = torch.Generator().manual_seed(5)
    out["t"], _ = draw_time_and_gamma(Schedule.from_config(SCHED), n, generator=g)
    out["after_u"] = torch.rand(3, generator=g)  # where gamma's uniforms left the stream
    out["u"] = draw_rows(torch.rand, n, generator=torch.Generator().manual_seed(6))
    out["noise"] = draw_rows(torch.randn, n, H, W, 1, generator=torch.Generator().manual_seed(7))
    out["chain"] = run_chain(chain_plan(Schedule.from_config(SCHED8), "ddpm"),
                             lambda x, lvl: torch.zeros_like(x), (n, H, W, 1), device="cpu",
                             generator=torch.Generator().manual_seed(8))
    torch.manual_seed(9)
    out["dropout"] = Dropout(0.5).train()(torch.ones(n, 4, 8, 16))
    model = build_model(toy_cfg())
    random_init_(model.unet, 0)
    batch = {k: torch.from_numpy(v[rows(n)]) for k, v in global_batch(1).items()}
    torch.manual_seed(10)
    with torch.no_grad():
        out["loss"] = model.loss(batch, Schedule.from_config(SCHED),
                                 generator=torch.Generator().manual_seed(11)).item()
    return out


def first_grads(trainer) -> dict:
    """The gradients the first optimizer step of `trainer` sees (after the
    ranks' reduction), by name, filled when that step runs."""
    grads = {}

    def hook(optimizer, args, kwargs):
        if not grads:
            grads.update({n: p.grad.clone() for n, p in trainer.model.unet.named_parameters()})

    trainer.optimizer.register_step_pre_hook(hook)
    return grads


def _rank_cases(out, opt):
    """The rank side of the module's tests; results to out/rank<r>.pt."""
    res = {"world": world_size(), "draws": _draws()}
    dh = build_data_handler(opt)
    res["n_train"] = len(dh.train_timestamps)
    try:
        DeviceDataset(dh, "cpu")
    except RuntimeError as e:
        res["device_cache_refused"] = str(e)

    saves = []
    save = CheckpointManager.save

    def counted(self, state, step, epoch):
        saves.append(step)
        return save(self, state, step, epoch)

    CheckpointManager.save = counted
    try:
        trainer = build_trainer(opt, torch.device("cpu"))
        grads = first_grads(trainer)
        first = run_training(opt, dh, trainer)
    finally:
        CheckpointManager.save = save
    res.update(losses=first["losses"], val=first["val"], saves=saves, grads=grads,
               params=trainer.model.unet.state_dict())

    again = copy.deepcopy(opt)
    again["path"]["resume_state"] = os.path.join(opt["path"]["checkpoint"], "I2_E1")
    again["path"]["checkpoint"] = opt["path"]["checkpoint"] + "_resumed"
    resumed = build_trainer(again, torch.device("cpu"))
    res["resumed_losses"] = run_training(again, dh, resumed)["losses"]

    bf16 = build_trainer({**opt, "path": {**opt["path"], "checkpoint": None}},
                         torch.device("cpu"), dtype=torch.bfloat16)
    res["bf16_grads"] = first_grads(bf16)
    res["bf16_loss"] = float(mean_across(bf16.train_on_batch_async(
        next(dh.train_batches(epoch=1)))))
    res["bf16_params"] = bf16.model.unet.state_dict()
    torch.save(res, os.path.join(out, f"rank{rank()}.pt"))


def rank_jax_slice(out, spec_path):
    """tests/test_torch_port_ddp_jax.py's rank side: per arch, DiffusionTrainer
    steps (DDP, Adam) on this rank's rows of the given global batches, with
    the given global draws handed to the loss; the mean losses, the first
    step's reduced gradients and the final parameters to out/jax_rank<r>.pt."""
    spec = torch.load(spec_path, weights_only=False)
    res = {}
    for arch, c in spec["archs"].items():
        model = build_model(c["cfg"])
        model.unet.load_state_dict(c["state"], strict=True)
        sched = Schedule.from_config(spec["sched"])
        trainer = DiffusionTrainer(model, sched, sched, device=torch.device("cpu"),
                                   lr=spec["lr"])
        grads = {}

        def first_grads(opt, args, kwargs, grads=grads, unet=model.unet):
            if not grads:
                grads.update({n: p.grad.clone() for n, p in unet.named_parameters()})

        trainer.optimizer.register_step_pre_hook(first_grads)
        losses = []
        for batch, draws in zip(c["batches"], c["draws"]):
            model.loss = functools.partial(
                DiffusionModel.loss, model, **{k: torch.from_numpy(v) for k, v in draws.items()})
            n = len(batch["HR"]) // world_size()
            local = {k: torch.from_numpy(v[rows(n)]) for k, v in batch.items()}
            losses.append(float(mean_across(trainer.train_on_batch_async(local))))
        res[arch] = {"losses": losses, "grads": grads, "params": model.unet.state_dict()}
    torch.save(res, os.path.join(out, f"jax_rank{rank()}.pt"))


# ------------------------------------------------------------- the ranks' run
@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ddp")
    make_synthetic_weatherbench(str(root / "data"), "2017-01-01-00", "2017-01-03-00",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    cfg = load_commented_json(os.path.join(
        REPO, "configs/experiment_configs/phydiff/resdiff+physics_train_example.json"))
    cfg["data"].update(dataroot=str(root / "data"), num_workers=2, batch_size=B,
                       val_batch_size=B, train_min_date="2017-01-01-00",
                       train_max_date="2017-01-02-01", val_min_date="2017-01-02-01",
                       val_max_date="2017-01-03-00")  # 25 and 23 hours: odd
    cfg["model"]["unet"].update(toy_cfg()["unet"])
    cfg["model"]["diffusion"].update(image_height=H, image_width=W, sampler="ddim", ddim_steps=2)
    cfg["path"]["experiments_folder_path"] = str(root)
    cfg["train"].update(n_iter=4, print_freq=1, val_freq=4, save_checkpoint_freq=2,
                        full_val_freq=1000)
    cfg["train"]["ema_scheduler"].update(enabled=True, step_start_ema=1)
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module")
def ranks(toy_tree):
    """(the ranks' results, the one-process references at the global batch)."""
    opt = Config(str(toy_tree / "cfg.json"), phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = str(toy_tree / "ckpt")
    out = toy_tree / "ranks"
    out.mkdir()
    build_data_handler(opt)  # the scaler cache, written once before the ranks read it
    procs = start_ranks(_rank_cases, str(out), opt)
    try:
        ref = {"draws": _draws(WORLD * B)}
        single = {**opt, "path": {**opt["path"], "checkpoint": None}}
        glob_dh = GlobalHandler([build_data_handler(opt, process_index=i, process_count=WORLD)
                                 for i in range(WORLD)])
        trainer = build_trainer(single, torch.device("cpu"))
        ref["grads"] = first_grads(trainer)
        run = run_training(single, glob_dh, trainer)
        ref.update(losses=run["losses"], val=run["val"], params=trainer.model.unet.state_dict())
        bf16 = build_trainer(single, torch.device("cpu"), dtype=torch.bfloat16)
        ref["bf16_grads"] = first_grads(bf16)
        ref["bf16_loss"] = bf16.train_on_batch(next(glob_dh.train_batches(epoch=1)))
    finally:
        join_ranks(procs)
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return got, ref, opt


# ---------------------------------------------------------------------- draws
def test_world_one_draws_are_the_plain_draws():
    """Without a process group the loss and the chain draw exactly what one
    process drew before data parallelism: t, gamma's uniforms, then the
    noise, each of the batch's shape, from one generator."""
    sched = Schedule.from_config(SCHED)
    g = torch.Generator().manual_seed(3)
    t = torch.randint(1, 1001, (1,), generator=g)
    u = torch.rand(B, generator=g)
    noise = torch.randn((B, H, W, 1), generator=g)
    model = build_model(toy_cfg())
    random_init_(model.unet, 0)
    batch = {k: torch.from_numpy(v[:B]) for k, v in global_batch(2).items()}
    with torch.no_grad():
        want = model.loss(batch, sched, t=t, u=u, noise=noise, train=False)
        got = model.loss(batch, sched, generator=torch.Generator().manual_seed(3), train=False)
    assert world_size() == 1 and got.item() == want.item()
    g = torch.Generator().manual_seed(3)
    t2, gamma = draw_time_and_gamma(sched, B, generator=g)
    assert int(t2) == int(t)
    torch.testing.assert_close(gamma, draw_time_and_gamma(sched, B, t=t, u=u)[1], rtol=0, atol=0)
    torch.testing.assert_close(draw_rows(torch.randn, B, H, W, 1, generator=g), noise,
                               rtol=0, atol=0)

    plan = chain_plan(Schedule.from_config(SCHED8), "ddpm")
    g = torch.Generator().manual_seed(4)
    init = torch.randn((B, H, W, 1), generator=g)
    noises = {i: torch.randn((B, H, W, 1), generator=g) for i in range(7, 0, -1)}
    eps = lambda x, lvl: 0.5 * x  # noqa: E731
    want = run_chain(plan, eps, (B, H, W, 1), device="cpu", init=init,
                     noises=[noises.get(i) for i in range(8)])
    got = run_chain(plan, eps, (B, H, W, 1), device="cpu",
                    generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("draw", ["u", "noise", "chain", "dropout"])
def test_rank_rows_of_a_draw_are_the_global_draws_rows(ranks, draw):
    got, ref, _ = ranks
    for r in range(WORLD):
        torch.testing.assert_close(got[r]["draws"][draw], ref["draws"][draw][r * B:(r + 1) * B],
                                   rtol=0, atol=0)


def test_t_is_one_draw_for_the_global_batch(ranks):
    """t is the same on every rank and the one-process draw's; gamma's
    uniforms took the global batch's count from the stream (the next draw
    agrees)."""
    got, ref, _ = ranks
    for r in range(WORLD):
        assert int(got[r]["draws"]["t"]) == int(ref["draws"]["t"])
        torch.testing.assert_close(got[r]["draws"]["after_u"], ref["draws"]["after_u"],
                                   rtol=0, atol=0)


def test_rank_losses_average_to_the_global_loss(ranks):
    """A loss drawn inside (t, gamma, noise, dropout 0.2) on each rank's rows:
    the ranks' mean is the one-process loss of the global batch."""
    got, ref, _ = ranks
    mean = sum(g["draws"]["loss"] for g in got) / WORLD
    assert abs(mean - ref["draws"]["loss"]) <= 1e-6 * abs(ref["draws"]["loss"])


# ------------------------------------------------------------------- training
def test_ranks_stride_the_tree_and_refuse_the_device_cache(ranks):
    got, _, opt = ranks
    dh = build_data_handler(opt)
    n = len(dh.train_timestamps)
    assert n == 25  # odd: the strides are trimmed to 12 each
    assert all(g["world"] == WORLD and g["n_train"] == n // WORLD for g in got)
    assert all("one process" in g["device_cache_refused"] for g in got)


def test_ddp_losses_match_one_process_at_the_global_batch(ranks):
    got, ref, _ = ranks
    steps = [s for s, _ in ref["losses"]]
    assert steps == [1, 2, 3, 4]
    for g in got:
        assert [s for s, _ in g["losses"]] == steps
        assert rel([v for _, v in g["losses"]], [v for _, v in ref["losses"]]) <= RTOL


def test_ddp_grads_and_params_match_one_process_and_each_other(ranks):
    """The first step's reduced gradients and the parameters after 4 Adam
    steps, leaf by leaf, against one process at the global batch; the two
    ranks' parameters bit for bit."""
    got, ref, _ = ranks
    for k, v in ref["grads"].items():
        assert norm_rel(got[0]["grads"][k], v) <= RTOL, k
    for k, v in ref["params"].items():
        assert norm_rel(got[0]["params"][k], v) <= RTOL, k
        torch.testing.assert_close(got[1]["params"][k], got[0]["params"][k], rtol=0, atol=0)


def test_gathered_validation_matches_one_process(ranks):
    """run_validation at step 4 (one batch of 2 rows per rank, DDIM-2),
    gathered: every rank's metrics are those of the global batch."""
    got, ref, _ = ranks
    (step, want), = ref["val"]
    for g in got:
        (s, metrics), = g["val"]
        assert s == step == 4 and metrics.keys() == want.keys()
        for k, v in want.items():
            assert metrics[k] == pytest.approx(v, rel=VAL_RTOL), k


def test_bf16_step_matches_one_process(ranks):
    """One bf16 step over float32 master weights: the loss within RTOL, the
    reduced float32 gradients within one bf16 ulp per leaf (each rank rounds
    its 2-row weight-gradient sums to bf16, one process its 4-row sums), the
    ranks' float32 parameters bit for bit. The parameters are not held to
    the one process's: Adam's first step moves each weight by +-lr, and a
    gradient element that bf16 rounding leaves near zero (a zero-init
    bias's, say) moves either way."""
    got, ref, _ = ranks
    for g in got:
        assert abs(g["bf16_loss"] - ref["bf16_loss"]) <= RTOL * abs(ref["bf16_loss"])
    for k, v in ref["bf16_grads"].items():
        assert norm_rel(got[0]["bf16_grads"][k], v) <= BF16_ULP, k
    for k, v in got[0]["bf16_params"].items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(got[1]["bf16_params"][k], v, rtol=0, atol=0)


def test_only_rank_0_writes_checkpoints(ranks):
    got, _, opt = ranks
    assert got[0]["saves"] == [2, 4, 4] and got[1]["saves"] == []
    assert sorted(os.listdir(opt["path"]["checkpoint"])) == ["I2_E1", "I4_E1"]
    for d in glob.glob(os.path.join(opt["path"]["checkpoint"], "*")):
        assert os.listdir(d) == ["state.pt"]


def test_resume_on_two_ranks_repeats_the_uninterrupted_steps(ranks):
    """Resumed from I2_E1 inside epoch 1 (6 steps of 2 rows per rank): both
    ranks skip the two batches trained on and log steps 3 and 4 as the
    uninterrupted run did."""
    got, _, _ = ranks
    for g in got:
        assert g["resumed_losses"] == g["losses"][2:]


# ----------------------------------------------------------------- processes
def test_process_group_refuses_a_partial_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK"):
        init_distributed("gloo")
    assert local_device("cpu") == torch.device("cpu") and world_size() == 1 and rank() == 0
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        local_device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            local_device("cuda")
    with pytest.raises(ValueError, match="cuda:LOCAL_RANK"):
        local_device("cuda:1")


def _torchrun(module, cfg, env):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", "-m", module, "-c", str(cfg), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


@pytest.fixture
def one_thread_env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def test_train_entry_point_under_torchrun(toy_tree, one_thread_env):
    cfg = load_commented_json(str(toy_tree / "cfg.json"))
    cfg["path"]["experiments_folder_path"] = str(toy_tree / "torchrun")
    cfg["train"].update(n_iter=3, val_freq=3)
    (toy_tree / "torchrun.json").write_text(json.dumps(cfg))
    r = _torchrun("srewd_tpu_torch.train", toy_tree / "torchrun.json", one_thread_env)
    assert r.returncode == 0, r.stderr[-4000:]
    runs = glob.glob(str(toy_tree / "torchrun" / "experiments" / "*"))
    assert len(runs) == 1  # rank 0 named the run; rank 1 took its directories
    assert sorted(os.listdir(os.path.join(runs[0], "checkpoint"))) == ["I2_E1", "I3_E1"]
    logs = os.path.join(runs[0], "logs")
    train_log = open(os.path.join(logs, "train.log")).read()
    assert train_log.count("l_pix") == 3 and "Rank 0 of 2 on cpu." in train_log
    assert "Rank 1 of 2 on cpu." in open(os.path.join(logs, "train_rank1.log")).read()
    assert "SSIM" in open(os.path.join(logs, "val.log")).read()


def test_pretrain_entry_point_under_torchrun(toy_tree, one_thread_env):
    pre = load_commented_json(os.path.join(
        REPO, "configs/experiment_configs/rrdb/pretrained_rrdb_17block_base.json"))
    pre["data"].update(load_commented_json(str(toy_tree / "cfg.json"))["data"], batch_size=4,
                       val_batch_size=4)
    pre["model"].update(hidden_size=8, num_block=2)
    pre["train"]["epoch"] = 1
    pre["path"]["experiments_folder_path"] = str(toy_tree / "pretrain")
    (toy_tree / "pre.json").write_text(json.dumps(pre))
    r = _torchrun("srewd_tpu_torch.pretrain", toy_tree / "pre.json", one_thread_env)
    assert r.returncode == 0, r.stderr[-4000:]
    (run,) = glob.glob(str(toy_tree / "pretrain" / "experiments" / "*"))
    assert os.listdir(os.path.join(run, "checkpoint")) == ["pretrain_rrdb_E0"]
    log = open(os.path.join(run, "logs", "train.log")).read()
    assert "Epoch [1/1], Iter 3," in log  # 12 hours per rank at 4 rows


def test_dryrun_multihost(tmp_path, one_thread_env):
    out = tmp_path / "multihost.json"
    r = subprocess.run([sys.executable, "-m", "srewd_tpu_torch.dryrun_multihost", str(out)],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=one_thread_env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    result = json.loads(out.read_text())
    assert result["ok"] and result["ranks_agree"] and result["n_processes"] == 2
    assert len(result["losses_multiprocess"]) == result["steps"] == 3
