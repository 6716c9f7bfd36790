"""The port's serving engine (automoe_tpu_torch/infer/engine.py) against
the JAX package's InferenceEngine(dtype=float32) on the same weights and
camera frames, the batching server round trip, device selection, and the
port's independence from JAX."""
from __future__ import annotations

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (
    CAM_HW,
    S,
    jax_model_and_variables,
    port_config,
    rel_err,
    small_config,
    tmp_path,  # noqa: F401  (removes what tests write)
)


@pytest.fixture(scope="module")
def weights():
    from automoe_tpu_torch.ckpt import state_dict_from_jax

    _, variables = jax_model_and_variables(seed=3)
    return variables, state_dict_from_jax(variables, port_config(small_config()))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(80)
    return (rng.integers(0, 256, (2, *CAM_HW, 3), dtype=np.uint8),
            rng.uniform(0, 40, size=2).astype(np.float32))


@pytest.fixture(scope="module")
def jax_out(weights, frames):
    from automoe_tpu.infer.engine import InferenceEngine

    eng = InferenceEngine(small_config(), weights[0], camera_hw=CAM_HW,
                          model_hw=(S, S), dtype=jnp.float32)
    return eng.infer_batch(*frames)


def _port_engine(weights, **kw):
    from automoe_tpu_torch.infer import InferenceEngine

    return InferenceEngine(port_config(small_config()), weights[1], camera_hw=CAM_HW,
                           model_hw=(S, S), device="cpu", **kw)


def test_f32_engine_matches_jax(weights, frames, jax_out):
    got = _port_engine(weights, dtype=torch.float32).infer_batch(*frames)
    assert sorted(got) == sorted(jax_out)
    for k, v in jax_out.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(),  # bf16
    dict(quantize=True),  # bf16 heads, int8 trunks, stem K3 (plain on the CPU)
    dict(quantize=True, stem_variant="pool"),  # stem conv + K4
], ids=["bf16", "int8", "int8-pool"])
def test_low_precision_engines_track_jax_f32(weights, frames, jax_out, kw):
    """bf16 rounding and int8 quantization move the outputs; the bounds
    are the JAX package's own for its int8 path (waypoint relative error
    < 0.03, expert weights within 0.05)."""
    calib = np.random.default_rng(81).integers(0, 256, (2, *CAM_HW, 3), dtype=np.uint8)
    got = _port_engine(weights, calib_frames=calib, **kw).infer_batch(*frames)
    assert rel_err(jax_out["waypoints"], got["waypoints"]) < 0.03
    np.testing.assert_allclose(got["expert_weights"], jax_out["expert_weights"], atol=0.05)
    np.testing.assert_allclose(got["expert_weights"].sum(-1), 1.0, rtol=1e-2)


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_batching_server_tcp_round_trip(weights, frames, pipeline_depth):
    from automoe_tpu_torch.serving import BatchingServer, Client, serve_tcp

    engine = _port_engine(weights, dtype=torch.float32)
    want = engine.infer_batch(*frames)
    with BatchingServer(engine, max_batch=2, max_wait_ms=40,
                        pipeline_depth=pipeline_depth) as batcher:
        srv = serve_tcp(batcher)
        try:
            client = Client(*srv.server_address[:2])
            rows = [client.infer(frames[0][i], float(frames[1][i])) for i in range(2)]
            client.close()
        finally:
            srv.shutdown()
    assert batcher.stats["requests"] == 2
    for i, row in enumerate(rows):
        for k in want:
            np.testing.assert_allclose(row[k], want[k][i], rtol=1e-4, atol=1e-5, err_msg=k)


def test_from_torch_checkpoint(weights, frames, tmp_path):
    from automoe_tpu_torch.infer import InferenceEngine

    path = tmp_path / "automoe.pth"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in weights[1].items()}}, path)
    got = InferenceEngine.from_torch_checkpoint(
        port_config(small_config()), str(path), camera_hw=CAM_HW, model_hw=(S, S),
        dtype=torch.float32, device="cpu").infer_batch(*frames)
    want = _port_engine(weights, dtype=torch.float32).infer_batch(*frames)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_entry_points_raise_without_gpu(monkeypatch):
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.models import create_automoe_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(small_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, camera_hw=CAM_HW, model_hw=(S, S))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_automoe_model(cfg)


def test_cuda_wrappers_reject_non_cuda_devices():
    from automoe_tpu_torch.ops.stem import _check_cuda

    with pytest.raises(ValueError):
        _check_cuda("k", torch.zeros(2, device="meta"))


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import automoe_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'automoe_tpu', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "assert 'automoe_tpu_torch.evals.cli' in names and len(names) >= 87, names\n"
        "assert {'automoe_tpu_torch.serving.export', 'automoe_tpu_torch.models.fused_experts'}"
        " <= set(names), names\n"
        "assert {'automoe_tpu_torch.infer.' + m for m in ('sim', 'run_automoe', 'carla_sim')}"
        " <= set(names), names\n"
        "assert {'automoe_tpu_torch.models.deep_policy'} | {'automoe_tpu_torch.tools.' + m for m in"
        " ('camera', 'campaign', 'checks', 'collect_carla', 'launch', 'preprocess_bdd100k',"
        " 'preprocess_carla', 'preprocess_nuscenes', 'redo_preprocess', 'supervisor')}"
        " <= set(names), names\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr


def test_serve_cli_on_cpu():
    from automoe_tpu_torch.serving import Client
    from automoe_tpu_torch.serving.cli import main

    srv, batcher = main(["--device", "cpu", "--fp32", "--quantize",
                         "--camera-hw", *map(str, CAM_HW), "--model-hw", str(S), str(S),
                         "--port", "0", "--max-batch", "1"], block=False)
    try:
        client = Client(*srv.server_address[:2])
        out = client.infer(np.zeros((*CAM_HW, 3), np.uint8), 10.0)
        client.close()
    finally:
        srv.shutdown()
        batcher.close()
    assert out["waypoints"].shape == (10, 2) and np.isfinite(out["waypoints"]).all()
    np.testing.assert_allclose(out["expert_weights"].sum(), 1.0, rtol=1e-5)
