"""Export bundles of the port (automoe_tpu_torch/serving/export.py) on the
CPU, on the JAX package's export-test config (drivable + image-only
nuScenes, 120x160 camera → 64x64):

* an exported f32 and int8 step equals the live port engine (rtol 1e-5,
  atol 1e-6, as the JAX package's tests/test_export.py) and rejects
  another input shape;
* `save_serving_bundle` → `ArtifactEngine` (meta, the non-bucket error,
  serving through `BatchingServer` and `automoe-serve-torch --bundle`)
  against the live JAX engine on the same weights (`state_dict_from_jax`;
  float32, rtol 1e-3 / atol 1e-4 as test_torch_port_engine.py's
  test_f32_engine_matches_jax);
* the traced graphs hold the stem kernels' custom-op nodes
  (`automoe.s2d_stem_pool_int8[_f32]`, `automoe.maxpool3x3s2_int8`), and
  `torch.library.opcheck` passes on each op's CPU implementation;
* a process that serves a bundle imports no JAX and no model, engine or
  quant module of the port.
The card's counterparts are in tests/test_torch_port_export_cuda.py."""
from __future__ import annotations

import io
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms
from tests.torch_port_common import module_tmp, tmp_path  # noqa: F401  (remove what tests write)

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
KEYS = ("waypoints", "speed", "speed_seq", "expert_weights")
EXACT = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    """(JAX variables with perturbed norms, the port's state dict of them)."""
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.utils import jit_init

    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.configs import load_model_config

    init = {"image": jnp.zeros((1, S, S, 3)), "speed": jnp.zeros((1, 1))}
    v = jax.device_get(jit_init(create_automoe_model(CFG, fast_gating_pool=True),
                                jax.random.key(0), init))
    rng = np.random.default_rng(7)
    variables = {"params": _perturb_norms(v["params"], rng),
                 "batch_stats": _perturb_norms(v["batch_stats"], rng)}
    return variables, state_dict_from_jax(variables, load_model_config(CFG))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(9)
    return (rng.integers(0, 256, (2, *CAM, 3), dtype=np.uint8),
            rng.uniform(0, 40, 2).astype(np.float32))


def _engine(weights, **kw):
    from automoe_tpu_torch.infer import InferenceEngine

    kw.setdefault("dtype", torch.float32)
    calib = np.random.default_rng(10).integers(0, 256, (2, *CAM, 3), dtype=np.uint8)
    return InferenceEngine(CFG, weights[1], camera_hw=CAM, model_hw=(S, S), device="cpu",
                           calib_frames=calib, **kw)


@pytest.fixture(scope="module")
def live(weights):
    return _engine(weights)


@pytest.fixture(scope="module")
def bundle(live, module_tmp):
    from automoe_tpu_torch.serving import save_serving_bundle

    return save_serving_bundle(live, module_tmp("bundle"), buckets=(2, 1))


def _ops(blob: bytes):
    """{custom op target: count} in an exported program's graph, and the
    kinds of its inputs."""
    ep = torch.export.load(io.BytesIO(blob))
    ops = [str(n.target) for n in ep.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("automoe.")]
    return ({o: ops.count(o) for o in ops},
            {s.kind.name for s in ep.graph_signature.input_specs})


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8-f32"])
def test_exported_step_equals_live_engine(weights, frames, quantize, tmp_path):
    from automoe_tpu_torch.serving import load_serving_step, save_serving_artifact

    engine = _engine(weights, quantize=quantize)
    ref = engine.infer_batch(frames[0][:1], frames[1][:1])
    path = save_serving_artifact(engine, tmp_path / "automoe.pt2")
    ops, inputs = _ops(path.read_bytes())
    # weights, matrices and int8 packs are the program's parameters and
    # buffers, not captured constants
    assert inputs == {"PARAMETER", "BUFFER", "USER_INPUT"}, inputs
    assert ops == ({"automoe.s2d_stem_pool_int8_f32.default": 1} if quantize else {})
    step = load_serving_step(path)
    out = step(frames[0][:1], frames[1][:1].reshape(1, 1))
    assert sorted(out) == sorted(ref)
    for k in KEYS:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), ref[k], **EXACT, err_msg=k)
    # the live engine is untouched by the export
    again = engine.infer_batch(frames[0][:1], frames[1][:1])
    for k in KEYS:
        np.testing.assert_array_equal(again[k], ref[k], err_msg=k)


def test_exported_step_rejects_another_shape(bundle, frames):
    from automoe_tpu_torch.serving import load_serving_step

    step = load_serving_step((bundle / "b1.pt2").read_bytes())
    with pytest.raises(Exception):  # rejected, not miscomputed
        step(frames[0], frames[1].reshape(2, 1))
    with pytest.raises(Exception):
        step(np.zeros((1, 96, 128, 3), np.uint8), np.zeros((1, 1), np.float32))


def test_artifact_engine_meta_and_buckets(bundle, live, frames):
    import json

    from automoe_tpu_torch.serving import ArtifactEngine

    assert json.loads((bundle / "meta.json").read_text()) == {
        "camera_hw": list(CAM), "buckets": [1, 2], "device": "cpu"}
    art = ArtifactEngine(bundle)
    assert art.camera_hw == CAM and art.buckets == [1, 2]
    want = live.infer_batch(*frames)
    got = art.infer_batch(*frames)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], **EXACT, err_msg=k)
    one = art.infer(frames[0][1], float(frames[1][1]))
    np.testing.assert_allclose(one["waypoints"], want["waypoints"][1], **EXACT)
    with pytest.raises(ValueError, match=r"no artifact for batch 3; bundle buckets: \[1, 2\]"):
        art.infer_batch(np.zeros((3, *CAM, 3), np.uint8), np.zeros(3))


def test_artifact_engine_serves_through_batching_server(bundle, live, frames):
    from automoe_tpu_torch.serving import ArtifactEngine, BatchingServer

    want = live.infer_batch(*frames)
    with BatchingServer(ArtifactEngine(bundle), max_batch=2, max_wait_ms=50,
                        buckets=[1, 2], pipeline_depth=2) as srv:
        assert srv.pipeline_depth == 1  # no dispatch_batch: serial
        row = srv.infer(frames[0][0], float(frames[1][0]))
    np.testing.assert_allclose(row["waypoints"], want["waypoints"][0], **EXACT)


def test_bundle_matches_live_jax_engine(bundle, weights, frames):
    from automoe_tpu.infer.engine import InferenceEngine as JaxEngine

    from automoe_tpu_torch.serving import ArtifactEngine

    jax_engine = JaxEngine(CFG, weights[0], camera_hw=CAM, model_hw=(S, S),
                           dtype=jnp.float32)
    want = jax_engine.infer_batch(*frames)
    got = ArtifactEngine(bundle).infer_batch(*frames)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], **JAX_TOL, err_msg=k)


@pytest.mark.parametrize("kw,op", [
    (dict(dtype=torch.bfloat16, quantize=True), "automoe.s2d_stem_pool_int8.default"),
    (dict(dtype=torch.bfloat16, quantize=True, stem_variant="pool"),
     "automoe.maxpool3x3s2_int8.default"),
], ids=["int8-K3", "int8-pool-K4"])
def test_traced_graph_holds_the_stem_kernel(weights, frames, kw, op):
    """The stem kernel is one node of the program, not its plain version's
    aten ops, so a bundle launches the kernel on the card; and the loaded
    program equals the live engine."""
    from automoe_tpu_torch.serving import export_serving_step, load_serving_step

    engine = _engine(weights, **kw)
    blob = export_serving_step(engine, batch_size=2)
    assert _ops(blob)[0] == {op: 1}
    want = engine.infer_batch(*frames)
    got = load_serving_step(blob)(frames[0], frames[1].reshape(2, 1))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], **EXACT, err_msg=k)


def _stem_args(dtype):
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(2, 14, 18, 12, generator=g).to(dtype)
    w = (torch.randn(192, 64, generator=g) * 0.05).to(dtype)
    return (xs, w, torch.randn(64, generator=g) * 0.1,
            127.0 / (torch.rand(64, generator=g) * 4 + 1))


@pytest.mark.parametrize("name", ["s2d_stem_pool_int8", "s2d_stem_pool_int8_f32",
                                  "maxpool3x3s2_int8"])
def test_opcheck_custom_ops_on_the_cpu(name):
    from automoe_tpu_torch.ops import stem

    op = getattr(torch.ops.automoe, name)
    if name == "maxpool3x3s2_int8":
        args = (torch.randint(-128, 128, (2, 9, 11, 32), dtype=torch.int8,
                              generator=torch.Generator().manual_seed(1)),)
        plain = stem.maxpool3x3s2_int8_plain
    else:
        args = _stem_args(torch.float32 if name.endswith("f32") else torch.bfloat16)
        plain = stem.s2d_stem_pool_int8_plain
    torch.library.opcheck(op, args)
    n = dict(stem.LAUNCHES)
    assert torch.equal(op(*args), plain(*args))
    assert stem.LAUNCHES == n  # the plain version launches nothing


def test_serving_a_bundle_imports_no_model_code(bundle, live, frames, tmp_path):
    np.save(tmp_path / "frame.npy", frames[0][:1])
    code = (
        "import sys, json, numpy as np\n"
        "from automoe_tpu_torch.serving.export import ArtifactEngine\n"
        f"art = ArtifactEngine({str(bundle)!r})\n"
        f"out = art.infer_batch(np.load({str(tmp_path / 'frame.npy')!r}), "
        f"np.asarray([{float(frames[1][0])!r}]))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'automoe_tpu')\n"
        "             or m.startswith(('automoe_tpu_torch.models', 'automoe_tpu_torch.infer',\n"
        "                              'automoe_tpu_torch.serving.quant')))\n"
        "print(json.dumps({'bad': bad, 'waypoints': out['waypoints'].tolist()}))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    import json

    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    want = live.infer_batch(frames[0][:1], frames[1][:1])
    np.testing.assert_allclose(np.asarray(got["waypoints"], np.float32), want["waypoints"],
                               **EXACT)


def test_serve_cli_with_a_bundle(bundle, live, frames):
    from automoe_tpu_torch.serving import Client
    from automoe_tpu_torch.serving.cli import main

    srv, batcher = main(["--bundle", str(bundle), "--port", "0", "--max-batch", "8",
                         "--max-wait-ms", "20"], block=False)
    try:
        assert batcher.buckets == [1, 2] and batcher.max_batch == 2
        client = Client(*srv.server_address[:2])
        out = client.infer(frames[0][1], float(frames[1][1]))
        client.close()
    finally:
        srv.shutdown()
        batcher.close()
    want = live.infer_batch(*frames)
    np.testing.assert_allclose(out["waypoints"], want["waypoints"][1], **EXACT)
    with pytest.raises(SystemExit, match="--ema applies at export time"):
        main(["--bundle", str(bundle), "--ema", "--port", "0"], block=False)


def test_cuda_bundle_raises_without_a_gpu(bundle, tmp_path, monkeypatch):
    import json

    from automoe_tpu_torch.serving import ArtifactEngine

    cuda = tmp_path / "cuda"
    cuda.mkdir()
    meta = json.loads((bundle / "meta.json").read_text())
    (cuda / "meta.json").write_text(json.dumps({**meta, "device": "cuda"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArtifactEngine(cuda)
