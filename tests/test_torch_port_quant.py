"""The port's int8 serving path (automoe_tpu_torch/serving/quant.py)
against the JAX package's serving/quant.py on the same weights, in
float32 on the CPU (the stems run their kernels' plain versions)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automoe_tpu.serving import quant as jq
from tests.torch_port_common import (
    jax_model_and_variables,
    make_batch,
    port_config,
    port_model,
    rel_err,
    small_config,
    to_torch_batch,
)


@pytest.fixture(scope="module")
def setup():
    _, variables = jax_model_and_variables(seed=2)
    cfg = small_config()
    calib = [make_batch(70)]
    jpack = jq.quantize_automoe(variables, cfg,
                                [{"image": jnp.asarray(calib[0]["image"])}],
                                dtype=jnp.float32)
    return cfg, variables, port_model(cfg, variables), calib, jpack


def _hwio(w):
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def test_fold_and_quantize_equal_jax(setup):
    from automoe_tpu_torch.serving.quant import fold_resnet, quantize_folded

    cfg, variables, pm, _, _ = setup
    for i, ecfg in enumerate(cfg.experts):
        name = "image_backbone" if ecfg.type == "nuscenes" else "backbone"
        jf = jq.fold_resnet(variables["params"][f"expert_{i}"][name],
                            variables["batch_stats"][f"expert_{i}"][name])
        expert = pm.experts[i]
        pf = fold_resnet(getattr(expert, name))
        assert sorted(pf) == sorted(jf)
        for k in jf:
            np.testing.assert_array_equal(_hwio(pf[k]["w"]), jf[k]["w"], err_msg=k)
            np.testing.assert_array_equal(pf[k]["b"], jf[k]["b"], err_msg=k)
        jqz, pqz = jq.quantize_folded(jf), quantize_folded(pf)
        for k in jqz:
            if "wq" in jqz[k]:
                np.testing.assert_array_equal(_hwio(pqz[k]["wq"]), jqz[k]["wq"], err_msg=k)
                np.testing.assert_array_equal(pqz[k]["sw"], jqz[k]["sw"], err_msg=k)
            else:
                np.testing.assert_array_equal(_hwio(pqz[k]["w"]), jqz[k]["w"], err_msg=k)


def test_calibration_scales_match_jax(setup):
    from automoe_tpu_torch.serving.quant import calibrate_automoe

    cfg, variables, pm, calib, jpack = setup
    got = calibrate_automoe(pm, [{"image": torch.from_numpy(calib[0]["image"])}],
                            dtype=torch.float32)
    for g, w in zip(got, jpack["scales"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("expert", [0, 3])
def test_q8_trunk_matches_jax(setup, expert):
    from automoe_tpu_torch.serving.quant import pack_trunk, resnet_quant_forward_q8

    cfg, variables, pm, calib, jpack = setup
    qj, scales = jpack["experts"][expert], jpack["scales"][expert]
    x = jnp.asarray(make_batch(71)["image"])
    stem = jq.stems_s2d_q8(jpack["experts"], jpack["scales"], x, dtype=jnp.float32)[expert]
    want = np.asarray(jq.resnet_quant_forward_q8(qj, scales, x, dtype=jnp.float32,
                                                 stem_in=stem))
    # the same quantized weights, in the port's layout
    qp = {k: ({"wq": np.ascontiguousarray(v["wq"].transpose(3, 2, 0, 1)),
               "sw": v["sw"], "b": v["b"]} if "wq" in v else v) for k, v in qj.items()}
    got = resnet_quant_forward_q8(
        pack_trunk(qp, scales, "cpu"), scales,
        (torch.from_numpy(np.array(stem[0])), stem[1]), dtype=torch.float32,
    ).numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.999, 1.0 - close.mean()


@pytest.mark.parametrize("variant", ["fused", "pool"])
def test_quant_forward_matches_jax(setup, variant):
    from automoe_tpu_torch.serving.quant import (
        make_quant_forward,
        prepare_qexperts,
        quantize_automoe,
    )

    cfg, variables, pm, calib, jpack = setup
    batch = make_batch(72)
    fwd = jq.make_quant_forward(cfg, jpack["scales"], dtype=jnp.float32)
    want = fwd(variables, jpack["experts"], {k: jnp.asarray(v) for k, v in batch.items()})

    ppack = quantize_automoe(pm, [{"image": torch.from_numpy(calib[0]["image"])}],
                             dtype=torch.float32)
    # The int8 trunk amplifies a 1e-6 change in an activation scale into
    # percent-level drift (rounding flips cascade through 16 convs), so the
    # forward is held on the JAX package's scales; the calibration itself
    # is pinned by test_calibration_scales_match_jax.
    ppack["scales"] = jpack["scales"]
    pfwd = make_quant_forward(port_config(cfg), ppack["scales"], dtype=torch.float32,
                              stem_variant=variant)
    got = pfwd(pm, prepare_qexperts(ppack, torch.float32, "cpu"), to_torch_batch(batch))
    assert got["waypoints"].shape == tuple(want["waypoints"].shape)
    assert rel_err(want["waypoints"], got["waypoints"].numpy()) < 1e-3
    np.testing.assert_allclose(got["expert_weights"].numpy(),
                               np.asarray(want["expert_weights"]), atol=1e-3)
