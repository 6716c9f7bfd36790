"""The plain versions of the port's int8 stem kernels (automoe_tpu_torch/
ops/stem.py) against the JAX package's Pallas kernels (interpret mode)
and XLA path, and the port's stems_s2d_q8 against the JAX one.

K3 (fused s2d conv + bias + ReLU + quantize + pool): int8 outputs within
±1 on under 0.1% of elements — the conv sums are taken in another order,
which can move a value across a rounding boundary. K4 (int8 pool):
bit-exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automoe_tpu.ops.pallas_stem import maxpool3x3s2_int8, s2d_stem_pool_int8

O = 256  # 4 experts x 64 stem channels, as on the serving path


def _s2d(x: np.ndarray) -> np.ndarray:
    b, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)))
    xs = xp.reshape(b, (h + 8) // 2, 2, (w + 8) // 2, 2, c)
    return xs.transpose(0, 1, 3, 2, 4, 5).reshape(b, (h + 8) // 2, (w + 8) // 2, 4 * c)


def _xla_ref(xs, w, bias, inv, hc, wc):
    dn = jax.lax.conv_dimension_numbers(xs.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    h = jax.lax.conv_general_dilated(xs, w, (1, 1), "VALID", dimension_numbers=dn)
    h = jax.nn.relu(h[:, :hc, :wc] + bias)
    hq = jnp.clip(jnp.round(h.astype(jnp.float32) * inv), -127, 127).astype(jnp.int8)
    return jax.lax.reduce_window(hq, np.int8(-128), jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0)))


def _assert_one_quantum(got, want, frac=1e-3):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, f"diff beyond one quantum: {d.max()}"
    assert (d > 0).mean() < frac, f"{(d > 0).mean():.2e} of elements differ"


def _stem_inputs(seed, bf16_values):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    w = (rng.normal(size=(4, 4, 12, O)) * 0.1).astype(np.float32)
    if bf16_values:  # the card's path feeds bf16; keep values bf16-exact
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    bias = rng.normal(size=(O,)).astype(np.float32)
    inv = (127.0 / np.abs(rng.normal(size=(O,)) * 5 + 6)).astype(np.float32)
    return _s2d(x), w, bias, inv


@pytest.mark.parametrize("bf16_values", [False, True])
def test_plain_stem_matches_pallas_and_xla(bf16_values):
    from automoe_tpu_torch.ops.stem import s2d_stem_pool_int8_plain

    xs, w, bias, inv = _stem_inputs(5, bf16_values)
    dtype = torch.bfloat16 if bf16_values else torch.float32
    got = s2d_stem_pool_int8_plain(
        torch.from_numpy(xs).to(dtype), torch.from_numpy(w.reshape(192, O)).to(dtype),
        torch.from_numpy(bias), torch.from_numpy(inv)).numpy()
    pallas = np.asarray(s2d_stem_pool_int8(jnp.asarray(xs), jnp.asarray(w),
                                           jnp.asarray(bias), jnp.asarray(inv),
                                           interpret=True))
    xla = np.asarray(_xla_ref(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(bias),
                              jnp.asarray(inv), 32, 32))
    assert got.shape == pallas.shape == (2, 16, 16, O)
    _assert_one_quantum(got, pallas)
    _assert_one_quantum(got, xla)


def test_stem_wrapper_on_cpu_is_the_plain_version():
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs(6, True)
    args = (torch.from_numpy(xs).bfloat16(), torch.from_numpy(w.reshape(192, O)).bfloat16(),
            torch.from_numpy(bias), torch.from_numpy(inv))
    stem.reset_launch_counts()
    assert torch.equal(stem.s2d_stem_pool_int8(*args), stem.s2d_stem_pool_int8_plain(*args))
    xq = torch.randint(0, 128, (1, 8, 8, 32), dtype=torch.int8)
    assert torch.equal(stem.maxpool3x3s2_int8(xq), stem.maxpool3x3s2_int8_plain(xq))
    assert stem.LAUNCHES == {"s2d_stem_pool_int8": 0, "maxpool3x3s2_int8": 0}


@pytest.mark.parametrize("shape", [(2, 32, 32, 128), (1, 128, 128, 256)])
def test_plain_pool_matches_pallas_exactly(shape):
    from automoe_tpu_torch.ops.stem import maxpool3x3s2_int8_plain

    xq = np.random.default_rng(7).integers(0, 128, size=shape).astype(np.int8)
    want = np.asarray(maxpool3x3s2_int8(jnp.asarray(xq), interpret=True))
    got = maxpool3x3s2_int8_plain(torch.from_numpy(xq)).numpy()
    np.testing.assert_array_equal(got, want)


def test_s2d_kernel_rewrite_matches_jax():
    from automoe_tpu.serving.quant import _s2d_stem_kernel as jax_rewrite
    from automoe_tpu_torch.serving.quant import _s2d_stem_kernel

    w = np.random.default_rng(8).normal(size=(7, 7, 3, 16)).astype(np.float32)
    got = _s2d_stem_kernel(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got, np.asarray(jax_rewrite(w)))


def _packs(seed, n=4):
    rng = np.random.default_rng(seed)
    jpacks, ppacks, scales = [], [], []
    for _ in range(n):
        w = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)
        b = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
        jpacks.append({"conv1": {"w": w, "b": b}})
        ppacks.append({"conv1": {"w": np.ascontiguousarray(w.transpose(3, 2, 0, 1)), "b": b}})
        scales.append({"layer1_0/conv1": float(abs(rng.normal()) * 4 + 4)})
    return jpacks, ppacks, scales


@pytest.mark.parametrize("variant,use_pallas", [("fused", False), ("pool", "pool")])
def test_stems_s2d_q8_matches_jax(variant, use_pallas):
    import automoe_tpu.ops.pallas_stem as ps
    from automoe_tpu.serving.quant import stems_s2d_q8 as jax_stems
    from automoe_tpu_torch.serving.quant import stems_s2d_q8

    jpacks, ppacks, scales = _packs(9)
    x = np.random.default_rng(10).normal(size=(2, 64, 64, 3)).astype(np.float32)
    orig = ps.maxpool3x3s2_int8
    try:  # the JAX "pool" mode runs its Pallas pool in interpret mode here
        ps.maxpool3x3s2_int8 = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        want = jax_stems(jpacks, scales, jnp.asarray(x), dtype=jnp.float32,
                         use_pallas=use_pallas)
    finally:
        ps.maxpool3x3s2_int8 = orig
    got = stems_s2d_q8(ppacks, scales, torch.from_numpy(x).permute(0, 3, 1, 2),
                       dtype=torch.float32, variant=variant)
    assert len(got) == len(want) == 4
    for (gq, gs), (wq, ws) in zip(got, want):
        assert gs == ws
        assert tuple(gq.shape) == tuple(wq.shape) == (2, 16, 16, 64)
        _assert_one_quantum(gq.numpy(), np.asarray(wq))
