"""The plain versions of the port's int8 stem kernels (automoe_tpu_torch/
ops/stem.py) against the JAX package's Pallas kernels (interpret mode)
and XLA path, and the port's stems_s2d_q8 against the JAX one.

K3 (fused s2d conv + bias + ReLU + pool + quantize, inv of either sign):
int8 outputs within ±1 on under 0.1% of elements — the conv sums are
taken in another order, which can move a value across a rounding
boundary. K4 (int8 pool):
bit-exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_common  # noqa: F401  (caps torch's intra-op threads)
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


def test_plain_stem_matches_pallas_with_mixed_sign_inv():
    """About half the channels with a negative inv and one with inv = 0:
    the plain version pools before it quantizes, as the Pallas kernel does,
    so it gives q(max h * inv) for either sign."""
    from automoe_tpu_torch.ops.stem import s2d_stem_pool_int8_plain

    xs, w, bias, inv = _stem_inputs(11, True)
    rng = np.random.default_rng(12)
    inv = (inv * np.where(rng.uniform(size=O) < 0.5, -1, 1)).astype(np.float32)
    inv[7] = 0.0
    assert 0.3 < (inv < 0).mean() < 0.7
    got = s2d_stem_pool_int8_plain(
        torch.from_numpy(xs).bfloat16(), torch.from_numpy(w.reshape(192, O)).bfloat16(),
        torch.from_numpy(bias), torch.from_numpy(inv)).numpy()
    pallas = np.asarray(s2d_stem_pool_int8(jnp.asarray(xs), jnp.asarray(w),
                                           jnp.asarray(bias), jnp.asarray(inv),
                                           interpret=True))
    assert got.shape == pallas.shape == (2, 16, 16, O)
    assert got[..., inv < 0].max() <= 0 < got[..., inv > 0].max()
    assert (got[..., 7] == 0).all()
    _assert_one_quantum(got, pallas)


def test_stem_wrapper_on_cpu_is_the_plain_version():
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs(6, True)
    args = (torch.from_numpy(xs).bfloat16(), torch.from_numpy(w.reshape(192, O)).bfloat16(),
            torch.from_numpy(bias), torch.from_numpy(inv))
    f32 = (args[0].float(), args[1].float(), *args[2:])
    stem.reset_launch_counts()
    assert torch.equal(stem.s2d_stem_pool_int8(*args), stem.s2d_stem_pool_int8_plain(*args))
    assert torch.equal(stem.s2d_stem_pool_int8(*f32), stem.s2d_stem_pool_int8_plain(*f32))
    xq = torch.randint(0, 128, (1, 8, 8, 32), dtype=torch.int8)
    assert torch.equal(stem.maxpool3x3s2_int8(xq), stem.maxpool3x3s2_int8_plain(xq))
    assert stem.LAUNCHES == {"s2d_stem_pool_int8": 0, "s2d_stem_pool_int8_f32": 0,
                             "maxpool3x3s2_int8": 0}


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does for finite values: add half of the
    13 dropped bits to the magnitude's bits, then clear them."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_three_tf32_passes_keep_f32_accuracy():
    """The split that K3's f32 kernel makes on the tensor cores, emulated in
    f32 on the CPU: v = hi + lo with hi = rna(v), lo = rna(v - hi), and the
    conv as hi*hi + (lo*hi + hi*lo). At B=2, a 128x128 input, O = 128 and
    the inputs' statistics of the card's tests, three passes give the
    plain version's int8 output within ±1 on at most 5e-5 of the elements;
    one pass (hi*hi alone, the tensor cores' own TF32) misses the 1e-3 that
    the kernels are held to, which is why the kernel takes three."""
    import torch.nn.functional as F

    from automoe_tpu_torch.ops.stem import quantize_int8, s2d_stem_pool_int8_plain

    rng = np.random.default_rng(13)
    B, H, O = 2, 128, 128
    xs = torch.from_numpy(rng.standard_normal((B, H // 2 + 4, H // 2 + 4, 12)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((192, O)) * 0.05).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(O) * 0.1).astype(np.float32))
    inv = torch.from_numpy((127.0 / (rng.random(O) * 4 + 1)).astype(np.float32))

    def conv(x, k):
        k = k.reshape(4, 4, 12, O).permute(3, 2, 0, 1)
        return F.conv2d(x.permute(0, 3, 1, 2), k)[:, :, : H // 2, : H // 2]

    def finish(h):
        pooled = F.max_pool2d(torch.relu(h + bias[:, None, None]), 3, 2, 1)
        return quantize_int8(pooled, inv[:, None, None]).permute(0, 2, 3, 1)

    x_hi, w_hi = _tf32_rna(xs), _tf32_rna(w)
    x_lo, w_lo = _tf32_rna(xs - x_hi), _tf32_rna(w - w_hi)
    assert (x_hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((xs - x_hi - x_lo).abs() <= xs.abs() * 2.0 ** -22).all()
    ref = s2d_stem_pool_int8_plain(xs, w, bias, inv)
    three = finish(conv(x_hi, w_hi) + (conv(x_lo, w_hi) + conv(x_hi, w_lo)))
    one = finish(conv(x_hi, w_hi))
    assert three.shape == one.shape == ref.shape == (B, 32, 32, O)
    _assert_one_quantum(three.numpy(), ref.numpy(), frac=5e-5)
    d = (one.int() - ref.int()).abs()
    assert (d > 0).float().mean() > 1e-3


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
