"""The stem kernels as `torch.library` custom ops on the card (ops/stem.py),
and an int8 export bundle there (serving/export.py). Marked `cuda`: each
test skips where no GPU is present. On a GPU machine without JAX, run
them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_export_cuda.py

A bundle and the live engine run the same kernels on the same inputs, so
their float32 outputs agree to rtol 1e-5 / atol 1e-6 (the CPU tests'
bound); the kernels' ops equal their plain versions as in
tests/test_torch_port_cuda.py (K3: int8 outputs within ±1 on at most 0.1%
of the elements, K4 bit-exact)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CAM, S = (120, 160), 64
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


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_stem_op_on_the_card_matches_plain(gen, dtype):
    from automoe_tpu_torch.ops import stem

    xs = torch.randn(2, 68, 68, 12, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(192, 128, device="cuda", generator=gen) * 0.05).to(dtype)
    bias = torch.randn(128, device="cuda", generator=gen) * 0.1
    inv = 127.0 / (torch.rand(128, device="cuda", generator=gen) * 4 + 1)
    name = "s2d_stem_pool_int8_f32" if dtype == torch.float32 else "s2d_stem_pool_int8"
    n = dict(stem.LAUNCHES)
    out = getattr(torch.ops.automoe, name)(xs, w, bias, inv)
    torch.cuda.synchronize()
    assert stem.LAUNCHES == {**n, name: n[name] + 1}
    d = (out.int() - stem.s2d_stem_pool_int8_plain(xs, w, bias, inv).int()).abs()
    assert out.shape == (2, 32, 32, 128) and int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= 1e-3


def test_pool_op_on_the_card_matches_plain(gen):
    from automoe_tpu_torch.ops import stem

    x = torch.randint(-128, 128, (2, 33, 47, 64), device="cuda", dtype=torch.int8,
                      generator=gen)
    n = stem.LAUNCHES["maxpool3x3s2_int8"]
    out = torch.ops.automoe.maxpool3x3s2_int8(x)
    assert stem.LAUNCHES["maxpool3x3s2_int8"] == n + 1
    assert torch.equal(out, stem.maxpool3x3s2_int8_plain(x))


@pytest.mark.parametrize("kw,kernel", [
    (dict(dtype=torch.float32, quantize=True), "s2d_stem_pool_int8_f32"),
    (dict(dtype=torch.float32, quantize=True, stem_variant="pool"), "maxpool3x3s2_int8"),
], ids=["int8-K3-f32", "int8-pool-K4"])
def test_int8_bundle_on_the_card_equals_the_live_engine(gen, tmp_path, kw, kernel):
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.serving.export import ArtifactEngine, save_serving_bundle

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, *CAM, 3), dtype=np.uint8)
    speeds = np.asarray([4.0, 17.0], np.float32)
    engine = InferenceEngine(CFG, camera_hw=CAM, model_hw=(S, S), device="cuda",
                             calib_frames=frames, **kw)
    want = engine.infer_batch(frames, speeds)
    art = ArtifactEngine(save_serving_bundle(engine, tmp_path / "b", buckets=(1, 2)))
    stem.reset_launch_counts()
    got = art.infer_batch(frames, speeds)
    one = art.infer(frames[1], float(speeds[1]))
    assert stem.LAUNCHES[kernel] == 2 and sum(stem.LAUNCHES.values()) == 2, stem.LAUNCHES
    for k in ("waypoints", "speed", "speed_seq", "expert_weights"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(one[k], want[k][1], rtol=1e-5, atol=1e-6, err_msg=k)
