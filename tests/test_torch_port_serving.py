"""The port's serving layer on the CPU: SamplerService against the JAX
package's (on one replica and on two), against its own generate_sr, the
batching cases of tests/test_serving.py, the HTTP front end, and the entry
points (`from_checkpoint` and export_sampler's CLI on one config,
bench_serve). Several replicas: tests/test_torch_port_replicas.py.

Toy width (inner 8, 4 groups, mults (1, 2), attention at 8x16, one res
block) over 16x32 fields, T = 6 DDPM, as tests/test_serving.py. The JAX
weights come through utils/jax_params.py; the JAX service's noise for
device batch `seq` is fold_in(key(seed), seq), which the port service takes
through its `noise` input (the port's noise rule).
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.data.scalers import MonthlyScalerSet as JScalers
from srewd_tpu.data.store import make_synthetic_weatherbench
from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu.ops.resize import bicubic_up4 as jax_bicubic_up4
from srewd_tpu.parallel.mesh import make_mesh
from srewd_tpu.serving import SamplerService as JSamplerService
from srewd_tpu_torch import export_sampler as export_cli
from srewd_tpu_torch import serve as serve_cli
from srewd_tpu_torch.data.scalers import MonthlyScalerSet
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.serving.export import load_sampler
from srewd_tpu_torch.serving.http import _b64_decode, _b64_encode, make_server
from srewd_tpu_torch.serving.service import SamplerService
from srewd_tpu_torch.utils.jax_params import unet_state_from_jax
from srewd_tpu_torch.utils.seeding import member_seed

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    _jax_noise, one_torch_thread, rel_rmse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 16, 32
LH, LW = H // 4, W // 4
CPU = torch.device("cpu")
SCHED = {"schedule": "linear", "n_timestep": 6, "linear_start": 1e-6, "linear_end": 1e-2}


def toy_cfg(arch):
    return {
        "architecture": arch,
        "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": 8, "norm_groups": 4,
                 "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                 "dropout": 0.0},
        "diffusion": {"image_height": H, "image_width": W, "image_channels": 1,
                      "channels": 1, "conditional": True},
    }


def jax_tree(jmodel, seed):
    """A seeded tree of the JAX model's params, each leaf at its own scale."""
    batch = {"HR": jnp.zeros((1, H, W, 1)), "LR": jnp.zeros((1, LH, LW, 1))}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                   / np.sqrt(max(1, np.prod(s.shape[:-1])))).astype(np.float32),
                        shapes)


def make_pair(arch, seed=1):
    """(JAX model, JAX params, port model with the same weights)."""
    jmodel = jax_build_model(toy_cfg(arch))
    tree = jax_tree(jmodel, seed)
    port = build_model(toy_cfg(arch))
    port.unet.load_state_dict(unet_state_from_jax(tree["unet"]), strict=True)
    return jmodel, tree, port


@pytest.fixture(scope="module")
def stack():
    """(port model, its params, schedule) of the toy sr3."""
    _, _, port = make_pair("sr3")
    return port, port.params(), Schedule.from_config(SCHED)


def _lr(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, LH, LW, 1)).astype(np.float32)


def _direct(stack_t, lr, seq, seed=0):
    """What the service must give for device batch `seq` holding `lr`: its
    generate_sr with the batch's generator."""
    model, _, sched = stack_t
    g = torch.Generator().manual_seed(member_seed(seed, seq))
    return model.generate_sr({"LR": torch.from_numpy(lr)}, sched, generator=g).numpy()


def _scalers(rng, cls):
    mean = rng.normal(280, 5, (13, 1, 1, 1)).astype(np.float32)
    std = rng.uniform(2, 4, (13, 1, 1, 1)).astype(np.float32)
    return (cls(mean, std, "GlobalStandardScaling"),
            cls(mean + 1, std * 2, "GlobalStandardScaling"))


@pytest.fixture(scope="module", params=["sr3", "phydiff"])
def jax_served(request):
    """The JAX service on make_mesh(1), once per arch: a 6-field request over
    batch 4 (two device batches, the second padded) and a 1-field request
    behind it, with Kelvin scalers; the port model with the same weights."""
    arch = request.param
    jmodel, tree, port = make_pair(arch)
    rng = np.random.default_rng(3)
    j_lr_sc, j_hr_sc = _scalers(rng, JScalers)
    reqs = [(280 + 3 * _lr(6, seed=4), np.array([1, 2, 3, 4, 5, 6], np.int32)),
            (280 + 3 * _lr(1, seed=5), np.array([7], np.int32))]
    with JSamplerService(jmodel, tree, JSchedule.from_config(SCHED), batch_size=4,
                         mesh=make_mesh(1), transform_lr=j_lr_sc.transform,
                         inverse_hr=j_hr_sc.inverse) as jsvc:
        want = [jsvc.submit(lr, m) for lr, m in reqs]
        want = [f.result(timeout=300) for f in want]
    return arch, port, (j_lr_sc, j_hr_sc), reqs, want


@pytest.mark.parametrize("replicas", [1, 2])
def test_service_matches_jax_service_split_padded_kelvin(jax_served, replicas):
    """Same weights, scalers and draws, on one port replica or two: the JAX
    service's fields, field by field in normalized space within
    test_generate_sr_matches_jax's bound (relative RMSE <= 1e-3 of the
    chain's own output: the residual for phydiff). A linger of 200 ms lets
    the 1-field request join the second batch whatever replica takes it."""
    arch, port, (j_lr_sc, j_hr_sc), reqs, want = jax_served
    lr_sc, hr_sc = (MonthlyScalerSet(s.mean, s.std, "GlobalStandardScaling")
                    for s in (j_lr_sc, j_hr_sc))
    base = jax.random.key(0)

    def noise(seq, shape, n):
        return _jax_noise(jax.random.fold_in(base, seq), shape, n)

    with SamplerService(port, port.params(), Schedule.from_config(SCHED), batch_size=4,
                        devices=[CPU] * replicas, transform_lr=lr_sc.transform,
                        inverse_hr=hr_sc.inverse, noise=noise, linger_ms=200.0) as svc:
        got = [svc.submit(lr, m) for lr, m in reqs]
        got = [f.result(timeout=300) for f in got]
        stats = svc.stats()
    assert stats["device_batches"] == 2 and stats["padded_fields"] == 1
    assert len(stats["device_batches_per_replica"]) == replicas
    for (lr, m), g, w in zip(reqs, got, want):
        assert g.shape == w.shape == (len(m), H, W, 1)
        cond = (np.asarray(jax_bicubic_up4(jnp.asarray(lr_sc.transform(lr, m))))
                if arch != "sr3" else 0.0)
        gn, wn = hr_sc.transform(g, m) - cond, hr_sc.transform(w, m) - cond
        for i in range(len(m)):
            assert rel_rmse(gn[i], wn[i]) <= 1e-3, (arch, i)


def test_service_is_bit_identical_to_generate_sr(stack):
    """Its own generators: device batch `seq` draws from member_seed(seed,
    seq), the padded tail included (tests/test_serving.py's contract)."""
    lr = _lr(6, seed=1)
    with SamplerService(*stack, batch_size=4, devices=CPU, seed=3) as svc:
        sr = svc.super_resolve(lr, np.ones(6, np.int32))
    np.testing.assert_array_equal(sr[:4], _direct(stack, lr[:4], 0, seed=3))
    padded = np.stack([lr[4], lr[5], lr[4], lr[4]])
    np.testing.assert_array_equal(sr[4:], _direct(stack, padded, 1, seed=3)[:2])


class TestBatching:
    def test_split_and_pad(self, stack):
        lr = _lr(6, seed=1)
        with SamplerService(*stack, batch_size=4, devices=CPU) as svc:
            sr = svc.super_resolve(lr, np.ones(6, np.int32))
            stats = svc.stats()
        assert sr.shape == (6, H, W, 1)
        assert stats["device_batches"] == 2 and stats["padded_fields"] == 2
        np.testing.assert_allclose(sr[:4], _direct(stack, lr[:4], 0), atol=1e-5)
        padded = np.stack([lr[4], lr[5], lr[4], lr[4]])
        np.testing.assert_allclose(sr[4:], _direct(stack, padded, 1)[:2], atol=1e-5)

    def test_concurrent_requests_coalesce(self, stack):
        lr = _lr(4, seed=2)
        with SamplerService(*stack, batch_size=4, devices=CPU, linger_ms=500.0) as svc:
            futs = [svc.submit(lr[i:i + 1], np.ones(1, np.int32)) for i in range(4)]
            rows = [f.result(timeout=120) for f in futs]
            stats = svc.stats()
        assert stats["device_batches"] == 1 and stats["padded_fields"] == 0
        assert stats["requests"] == 4
        expected = _direct(stack, lr, 0)
        for i, row in enumerate(rows):
            np.testing.assert_allclose(row[0], expected[i], atol=1e-5)

    def test_hot_swap_params(self, stack):
        model, params, sched = stack
        _, _, other = make_pair("sr3", seed=42)
        params2 = other.params()
        lr = _lr(4, seed=9)
        with SamplerService(*stack, batch_size=4, devices=CPU) as svc:
            first = svc.super_resolve(lr, np.ones(4, np.int32))
            svc.update_params(params2)
            second = svc.super_resolve(lr, np.ones(4, np.int32))
            # a structure mismatch is rejected before it can reach the queue
            with pytest.raises(ValueError, match="tree mismatch"):
                svc.update_params({"wrong_key": params2["unet"]})
            third = svc.super_resolve(lr, np.ones(4, np.int32))
        np.testing.assert_allclose(first, _direct(stack, lr, 0), atol=1e-5)
        np.testing.assert_allclose(second, _direct((other, params2, sched), lr, 1), atol=1e-5)
        np.testing.assert_allclose(third, _direct((other, params2, sched), lr, 2), atol=1e-5)
        assert not np.allclose(first, second)
        # the caller's model was never touched
        for k, v in model.unet.state_dict().items():
            assert torch.equal(v, params["unet"][k]), k

    def test_swap_waits_for_enqueued_batches(self, stack):
        """A batch taken before update_params finishes on the old weights."""
        _, _, other = make_pair("sr3", seed=42)
        lr = _lr(4, seed=9)
        with SamplerService(*stack, batch_size=4, devices=CPU) as svc:
            fut = svc.submit(lr, np.ones(4, np.int32))
            while svc.stats()["device_batches"] == 0:  # the dispatcher has taken it
                threading.Event().wait(0.005)
            svc.update_params(other.params())
            old = fut.result(timeout=120)
        np.testing.assert_allclose(old, _direct(stack, lr, 0), atol=1e-5)

    def test_closed_service_rejects(self, stack):
        svc = SamplerService(*stack, batch_size=2, devices=CPU)
        svc.close()
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit(_lr(1), np.ones(1, np.int32))

    def test_mismatched_field_shape_rejected(self, stack):
        with SamplerService(*stack, batch_size=4, devices=CPU) as svc:
            svc.super_resolve(_lr(2), np.ones(2, np.int32))
            bad = np.zeros((1, LH * 2, LW, 1), np.float32)
            with pytest.raises(ValueError, match="compiled shape"):
                svc.submit(bad, np.ones(1, np.int32))
            sr = svc.super_resolve(_lr(2, seed=5), np.ones(2, np.int32))
        assert sr.shape == (2, H, W, 1)

    def test_empty_request_rejected(self, stack):
        with SamplerService(*stack, batch_size=2, devices=CPU) as svc:
            with pytest.raises(ValueError, match="non-empty"):
                svc.submit(np.zeros((0, LH, LW, 1), np.float32), np.zeros(0, np.int32))

    def test_update_params_rejects_leaf_mismatch(self, stack):
        _, params, _ = stack
        wider = {part: {k: torch.cat([v] * 2, dim=-1) if v.ndim else v for k, v in sd.items()}
                 for part, sd in params.items()}
        half = {part: {k: v.half() for k, v in sd.items()} for part, sd in params.items()}
        with SamplerService(*stack, batch_size=2, devices=CPU) as svc:
            for bad in (wider, half):
                with pytest.raises(ValueError, match="leaf mismatch"):
                    svc.update_params(bad)

    def test_keep_every_and_no_card_rejected(self, stack):
        with pytest.raises(ValueError, match="keep_every"):
            SamplerService(*stack, devices=CPU, sampler_kwargs={"keep_every": 2})
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                SamplerService(*stack)  # the card is the default device


class TestKelvinBoundary:
    def test_scalers_applied_both_ways(self, stack):
        rng = np.random.default_rng(3)
        sc_lr, sc_hr = _scalers(rng, MonthlyScalerSet)
        months = np.array([1, 2, 3, 4], np.int32)
        lr_kelvin = (rng.standard_normal((4, LH, LW, 1)) * 3 + 280).astype(np.float32)
        with SamplerService(*stack, batch_size=4, devices=CPU, transform_lr=sc_lr.transform,
                            inverse_hr=sc_hr.inverse) as svc:
            sr = svc.super_resolve(lr_kelvin, months)
        norm = sc_lr.transform(lr_kelvin, months)
        expected = sc_hr.inverse(_direct(stack, norm, 0), months)
        np.testing.assert_allclose(sr, expected, atol=1e-4)

    def test_partial_failure_of_split_request_keeps_resolver_alive(self, stack):
        calls = {"n": 0}

        def bad_inverse(x, m):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("first batch explodes")
            return x

        with SamplerService(*stack, batch_size=2, devices=CPU, inverse_hr=bad_inverse) as svc:
            fut = svc.submit(_lr(4, seed=11), np.ones(4, np.int32))
            with pytest.raises(ValueError, match="first batch explodes"):
                fut.result(timeout=120)
            sr = svc.submit(_lr(2, seed=12), np.ones(2, np.int32)).result(timeout=120)
        assert sr.shape == (2, H, W, 1)

    def test_error_propagates_and_service_survives(self, stack):
        calls = {"n": 0}

        def bad_inverse(x, m):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("scaler exploded")
            return x

        with SamplerService(*stack, batch_size=2, devices=CPU, inverse_hr=bad_inverse) as svc:
            with pytest.raises(ValueError, match="scaler exploded"):
                svc.super_resolve(_lr(2), np.ones(2, np.int32))
            sr = svc.super_resolve(_lr(2, seed=5), np.ones(2, np.int32))
        assert sr.shape == (2, H, W, 1)


class TestHTTP:
    @pytest.fixture()
    def server(self, stack):
        svc = SamplerService(*stack, batch_size=2, devices=CPU)
        srv = make_server(svc, port=0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}", stack
        srv.shutdown()
        srv.server_close()
        svc.close()
        t.join(timeout=10)
        assert not t.is_alive()

    def _post(self, url, payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def test_healthz_and_stats(self, server):
        url, _ = server
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["batch_size"] == 2 and stats["replicas"] == ["cpu"]
        assert stats["device_batches_per_replica"] == [0]

    def test_super_resolve_json(self, server):
        url, stack_t = server
        lr = _lr(2, seed=7)
        out = self._post(url + "/v1/super_resolve", {"lr": lr.tolist(), "months": [1, 1]})
        sr = np.asarray(out["sr"], np.float32)
        np.testing.assert_allclose(sr, _direct(stack_t, lr, 0), atol=1e-4)

    def test_super_resolve_b64(self, server):
        url, stack_t = server
        lr = _lr(2, seed=8)
        out = self._post(url + "/v1/super_resolve", {"lr_b64": _b64_encode(lr), "months": [1, 1]})
        sr = _b64_decode(out["sr_b64"])
        assert sr.shape == (2, H, W, 1)
        np.testing.assert_array_equal(sr, _direct(stack_t, lr, 0))

    def test_bad_request_is_400(self, server):
        url, _ = server
        req = urllib.request.Request(url + "/v1/super_resolve", data=b'{"months": [1]}')
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400

    def test_submit_validation_error_is_400_not_500(self, server):
        url, _ = server
        req = urllib.request.Request(
            url + "/v1/super_resolve", data=json.dumps({"lr": [[1.0]], "months": [1]}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400


def test_bench_serve_prints_the_contract(capsys):
    """bench_serve's JSON line has the JAX script's keys; at toy size on the
    CPU (sr3 at inner 32, 32x64, DPM-2, batch 2): 3 requests of sizes 1, 2,
    1 make 4 fields in 2 or 3 device batches after the warm-up's (as they
    coalesce), and every slot of those timed batches is a field or a
    padded one."""
    from srewd_tpu_torch import bench_serve

    out = bench_serve.main(["--device", "cpu", "--hr-shape", "32", "64", "--inner-channel",
                            "32", "--t", "10", "--steps", "2", "--requests", "3", "--batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(out))
    assert {"metric", "value", "unit", "serialized_fields_per_sec",
            "pipeline_speedup_vs_serialized", "device_batches", "padded_fields",
            "latency_p50_ms", "latency_p95_ms"} <= set(out)
    assert out["metric"] == ("served SR fields/sec/chip (2-step DPM(T=10), 32x64, sr3, "
                             "3 mixed-size requests)")
    assert out["fields"] == 4 and out["device_batches"] in (2, 3)
    assert 2 * out["device_batches"] == 4 + out["padded_fields"]
    assert out["value"] > 0 and out["pipeline_speedup_vs_serialized"] == pytest.approx(
        out["value"] / out["serialized_fields_per_sec"])
    assert out["device"] == "cpu" and out["latency_p50_ms"] <= out["latency_p95_ms"]


@pytest.fixture(scope="module")
def tree_cfg(tmp_path_factory):
    """A toy phydiff config over a 16x32 / 4x8 synthetic t2m tree."""
    root = tmp_path_factory.mktemp("export_cli")
    make_synthetic_weatherbench(str(root / "data"), min_date="2017-01-01-00",
                                max_date="2017-01-02-00", lr_shape=(LH, LW), hr_shape=(H, W),
                                spectrum="t2m")
    with open(os.path.join(
            REPO, "configs/experiment_configs/phydiff/resdiff+physics_ddim50_eval.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(dataroot=str(root / "data"), num_workers=2,
                       train_min_date="2017-01-01-00", train_max_date="2017-01-01-12",
                       val_min_date="2017-01-01-12", val_max_date="2017-01-02-00",
                       months_subset=[1], transform_groups={"january": [1]})
    cfg["model"]["unet"].update(inner_channel=8, norm_groups=4, channel_multiplier=[1, 2],
                                attn_res=[8], res_blocks=1)
    cfg["model"]["diffusion"].update(image_height=H, image_width=W, ddim_steps=3)
    cfg["path"]["resume_state"] = None  # seeded weights (the config names a run's checkpoint)
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root


def test_export_cli_artifact_equals_the_served_fields(tree_cfg, capsys):
    """export_sampler's entry point and SamplerService.from_checkpoint on
    one config (seeded weights, the tree's Kelvin scalers, DPM-3): the
    artifact at seed s gives the service's device batch 0 at seed s."""
    out = str(tree_cfg / "m.srexport")
    res = export_cli.main(["-c", str(tree_cfg / "cfg.json"), "-o", out, "--sampler", "dpm",
                           "--ddim-steps", "3", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("EXPORT OK ")
    assert res["sampler"] == "dpm" and res["steps"] == 3 and res["kelvin"]["hr"]
    fn = load_sampler(out)
    rng = np.random.default_rng(0)
    lr_k = (280 + 5 * rng.standard_normal((2, LH, LW, 1))).astype(np.float32)
    months = np.ones(2, np.int32)
    with SamplerService.from_checkpoint(str(tree_cfg / "cfg.json"), devices="cpu", batch_size=2,
                                        seed=5, diffusion_overrides={"sampler": "dpm",
                                                                     "ddim_steps": 3}) as svc:
        served = svc.super_resolve(lr_k, months)
        assert svc.stack.sampler_kwargs == svc.sampler_kwargs  # the stack it serves, kept
    got = fn(lr_k, months, seed=5).numpy()
    assert 150 < got.min() and got.max() < 400
    np.testing.assert_allclose(got, served, atol=1e-4)


def test_entry_points_default_to_the_card(tree_cfg):
    """export_sampler, serve and bench_serve default to the card (serve and
    bench_serve to every visible card) and raise without one, as does a
    list of cards."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from srewd_tpu_torch import bench_serve

    cfg = str(tree_cfg / "cfg.json")
    for run in (lambda: export_cli.main(["-c", cfg, "-o", str(tree_cfg / "x.srexport")]),
                lambda: serve_cli.main(["-c", cfg, "--port", "0"]),
                lambda: serve_cli.main(["-c", cfg, "--port", "0", "--device", "cuda:0,cuda:0"]),
                lambda: bench_serve.main(["--hr-shape", "32", "64", "--inner-channel", "32"])):
        with pytest.raises(RuntimeError, match="cuda"):
            run()
