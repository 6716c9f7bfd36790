"""Data-parallel serving in the port (`InferenceEngine(devices=[...])`,
`automoe-serve-torch --data-parallel`) against the JAX package's meshed
engine (`InferenceEngine(mesh=MeshSpec(data=8))`) on the same weights,
mirroring tests/test_serving_mesh.py (a)-(d) with eight replicas on
`devices=["cpu"] * 8`; the JAX engines come from the one module fixture:

(a) the 8-replica engine equals JAX's 8-device engine (rtol 1e-3 / atol
    1e-4, the port's engine-vs-JAX tolerance) and the port's own
    one-device engine (rtol 1e-5 / atol 1e-6) on a batch of 8;
(b) a batch of 3 and a B=1 `infer` are repeat-padded to 8 and trimmed
    back, equal to both;
(c) the int8 trunk builds its pack on every replica, and equals the
    one-device int8 engine;
(d) the batching server over the replicated engine, and the CLI with
    --data-parallel answering over TCP.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

CFG = {
    "experts": [
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}
HW = (64, 80)
R = 8


def _frames(seed, b):
    return np.random.default_rng(seed).integers(0, 256, (b, *HW, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def engines():
    """JAX's plain and 8-device engines, and the port's one-device and
    8-replica engines on their weights, float32."""
    import jax.numpy as jnp

    from automoe_tpu.infer.engine import InferenceEngine as JaxEngine
    from automoe_tpu.parallel import MeshSpec, make_mesh

    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.infer import InferenceEngine

    jplain = JaxEngine(CFG, camera_hw=HW, model_hw=(64, 64), dtype=jnp.float32)
    jmesh = JaxEngine(CFG, variables=jplain.variables, camera_hw=HW, model_hw=(64, 64),
                      dtype=jnp.float32, mesh=make_mesh(MeshSpec(data=8, model=1)))
    sd = state_dict_from_jax(jax.device_get(jplain.variables), CFG)
    kw = dict(camera_hw=HW, model_hw=(64, 64), dtype=torch.float32)
    plain = InferenceEngine(CFG, sd, device="cpu", **kw)
    replicated = InferenceEngine(CFG, sd, devices=["cpu"] * R, **kw)
    frames, speeds = _frames(0, 8), np.linspace(0, 30, 8)
    return {"jax": jmesh, "plain": plain, "dp": replicated, "sd": sd,
            "want8": jmesh.infer_batch(frames, speeds), "batch8": (frames, speeds),
            "want3": jmesh.infer_batch(frames[:3], speeds[:3])}


def _close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_replicas_match_jax_mesh(engines):
    dp = engines["dp"]
    assert dp.batch_multiple == engines["jax"].batch_multiple == R
    assert len({id(r.model) for r in dp._replicas}) == R  # a model a replica
    got = dp.infer_batch(*engines["batch8"])
    _close(got, engines["want8"], 1e-3, 1e-4)
    _close(got, engines["plain"].infer_batch(*engines["batch8"]), 1e-5, 1e-6)


def test_replicas_pad_submultiple_batches(engines):
    dp, plain = engines["dp"], engines["plain"]
    frames, speeds = engines["batch8"]
    padded, _, real = dp._pad_group(frames[:3], speeds[:3].reshape(-1, 1))
    assert real == 3 and padded.shape[0] == R
    assert (padded[3:] == frames[2]).all()  # repeat-padded with the last frame
    got = dp.infer_batch(frames[:3], speeds[:3])
    _close(got, engines["want3"], 1e-3, 1e-4)
    _close(got, plain.infer_batch(frames[:3], speeds[:3]), 1e-5, 1e-6)
    one = dp.infer(frames[0], float(speeds[0]))
    np.testing.assert_allclose(one["waypoints"], got["waypoints"][:1], rtol=1e-5, atol=1e-6)


def test_replicas_quantized_trunk(engines):
    from automoe_tpu_torch.infer import InferenceEngine

    kw = dict(camera_hw=HW, model_hw=(64, 64), dtype=torch.float32, quantize=True,
              calib_frames=_frames(1, 2))
    dp = InferenceEngine(CFG, engines["sd"], devices=["cpu"] * R, **kw)
    packs = {id(r._qexperts) for r in dp._replicas}
    assert len(packs) == R and all(r._qexperts is not None for r in dp._replicas)
    frames = _frames(2, R)
    out = dp.infer_batch(frames, np.zeros(R))
    assert out["waypoints"].shape == (R, 4, 2) and np.isfinite(out["waypoints"]).all()
    _close(out, InferenceEngine(CFG, engines["sd"], device="cpu", **kw).infer_batch(
        frames, np.zeros(R)), 1e-5, 1e-6)


def test_server_over_replicated_engine(engines):
    from automoe_tpu_torch.serving.server import BatchingServer

    batcher = BatchingServer(engines["dp"], max_batch=8, max_wait_ms=2.0).start()
    try:
        futs = [batcher.submit(_frames(3 + i, 1)[0], float(i)) for i in range(5)]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        batcher.close()
    for o in outs:
        assert np.isfinite(np.asarray(o["waypoints"])).all()


def test_serve_cli_data_parallel(tmp_path):
    """`automoe-serve-torch --data-parallel` answers over TCP (one replica
    on the CPU: --device cpu has one device)."""
    from automoe_tpu_torch.serving import Client
    from automoe_tpu_torch.serving.cli import main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CFG))
    srv, batcher = main(["--data-parallel", "--device", "cpu", "--model-config", str(cfg),
                         "--camera-hw", *map(str, HW), "--model-hw", "64", "64", "--fp32",
                         "--port", "0"], block=False)
    try:
        assert batcher.engine.batch_multiple == 1
        host, port = srv.server_address[:2]
        out = Client(host, port).infer(_frames(9, 1)[0], 5.0)
        assert np.isfinite(np.asarray(out["waypoints"])).all()
    finally:
        srv.shutdown()
        batcher.close()
