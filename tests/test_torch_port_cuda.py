"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips where no GPU is present. On a GPU
machine without JAX, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,H,W", [(2, 64, 64), (3, 40, 72)])
def test_stem_kernel_matches_plain(gen, B, H, W):
    from automoe_tpu_torch.ops import stem

    xs = torch.randn(B, H // 2 + 4, W // 2 + 4, 12, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(192, 256, device="cuda", generator=gen) * 0.05).bfloat16()
    bias = torch.randn(256, device="cuda", generator=gen) * 0.1
    inv = 127.0 / (torch.rand(256, device="cuda", generator=gen) * 4 + 1)
    n = stem.LAUNCHES["s2d_stem_pool_int8"]
    out = stem.s2d_stem_pool_int8(xs, w, bias, inv)
    torch.cuda.synchronize()
    assert stem.LAUNCHES["s2d_stem_pool_int8"] == n + 1
    d = (out.int() - stem.s2d_stem_pool_int8_plain(xs, w, bias, inv).int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3


@pytest.mark.parametrize("shape", [(2, 32, 32, 128), (3, 33, 17, 32)])
def test_pool_kernel_matches_plain(gen, shape):
    from automoe_tpu_torch.ops import stem

    x = torch.randint(-128, 128, shape, device="cuda", dtype=torch.int8, generator=gen)
    out = stem.maxpool3x3s2_int8(x)
    torch.cuda.synchronize()
    assert torch.equal(out, stem.maxpool3x3s2_int8_plain(x))


def test_stem_kernel_rejects_bad_inputs(gen):
    from automoe_tpu_torch.ops import stem

    xs = torch.zeros(1, 36, 36, 12, device="cuda")  # f32, not bf16
    w = torch.zeros(192, 64, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError):
        stem.s2d_stem_pool_int8(xs, w, v, v)


@pytest.mark.parametrize("variant", ["fused", "pool"])
def test_int8_engine_on_cuda(gen, variant):
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine

    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    kw = dict(camera_hw=(96, 128), model_hw=(64, 64), device="cuda")
    ref = InferenceEngine(default_model_config(), **kw).infer_batch(frames, np.ones(2))
    out = InferenceEngine(default_model_config(), quantize=True, stem_variant=variant,
                          **kw).infer_batch(frames, np.ones(2))
    assert np.isfinite(out["waypoints"]).all()
    np.testing.assert_allclose(out["expert_weights"], ref["expert_weights"], atol=0.05)
