"""The closed loop of the PyTorch port (automoe_tpu_torch/infer: sim.py,
run_automoe.py, carla_sim.py) against the JAX package's on the CPU:

* MockSim: the same seed and scripted controls over 100 ticks give
  byte-equal frames and equal states;
* the loop logic: `run_closed_loop` of both packages over the same MockSim
  seed, driven by one scripted engine (seeded outputs, with NaN and empty
  waypoints and NaN speeds, inside and after the bootstrap): logs equal in
  every key but `infer_ms`;
* the engines in the loop (test_infer.py's tiny config, float32, camera
  120x160, model 64x64, 12 steps): steer, throttle, brake and speed within
  atol 1e-4, expert weights within 1e-5; with quantize=True, each step's
  outputs at the int8 tolerances of test_torch_port_engine.py (waypoint
  relative error < 0.03, expert weights within 0.05);
* `carla_image_to_rgb` (exact) and CarlaSim on tests/carla_stub.py;
* `automoe-infer-torch` in-process through `main(argv)`: files, backends,
  the --ema and --checkpoint rules, and the device rule.
The JAX engines run once per module."""
from __future__ import annotations

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms, rel_err
from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)

CAM_HW, MODEL_HW, STEPS = (120, 160), (64, 64), 12
TINY = {
    "experts": [
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}


def _drop_time(logs):
    return [{k: v for k, v in entry.items() if k != "infer_ms"} for entry in logs]


# ---------------------------------------------------------------------------
# MockSim and the loop logic
# ---------------------------------------------------------------------------

def test_mock_sim_matches_jax():
    from automoe_tpu.infer.sim import MockSim as JaxSim

    from automoe_tpu_torch.infer.sim import MockSim

    sims = [cls(camera_hw=(60, 80), fixed_dt=0.05, seed=4) for cls in (JaxSim, MockSim)]
    controls = np.random.default_rng(5).uniform(-1.5, 1.5, (100, 3))
    for throttle, steer, brake in controls:
        frames = []
        for sim in sims:
            sim.apply_control(throttle=throttle, steer=steer, brake=abs(brake) * 0.2)
            sim.tick()
            frames.append(sim.camera_frame())
        np.testing.assert_array_equal(frames[1], frames[0])
        assert frames[1].dtype == np.uint8
        assert vars(sims[1].state) == vars(sims[0].state)
        assert sims[1].speed_kmh == sims[0].speed_kmh
    assert sims[1].state.yaw != 0.0 and sims[1].speed_kmh > 0.0


class ScriptedEngine:
    """Seeded outputs of an engine's shape; some steps give NaN or empty
    waypoints and NaN speeds. Records the speeds it is given."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.warmups, self.speeds_in = 0, []

    def warmup(self):
        self.warmups += 1

    def infer(self, frame, last_speed_kmh):
        i = len(self.speeds_in)
        self.speeds_in.append(last_speed_kmh)
        assert frame.dtype == np.uint8 and frame.ndim == 3
        wps = (self.rng.normal(size=(1, 4, 2)) * 2 + [5.0, 0.0]).astype(np.float32)
        speed = self.rng.uniform(-5, 40, (1, 1)).astype(np.float32)
        logits = self.rng.normal(size=(1, 3))
        if i % 7 == 3:
            wps[0, 1, 1] = np.nan
        if i % 11 == 6:
            wps = np.zeros((1, 0, 2), np.float32)
        if i % 5 == 2:
            speed[:] = np.nan
        return {"waypoints": wps, "speed": speed,
                "expert_weights": (np.exp(logits) / np.exp(logits).sum()).astype(np.float32)}


def test_loop_logic_matches_jax(tmp_path):
    from automoe_tpu.infer.run_automoe import run_closed_loop as jax_loop
    from automoe_tpu.infer.sim import MockSim as JaxSim

    from automoe_tpu_torch.infer.run_automoe import run_closed_loop
    from automoe_tpu_torch.infer.sim import MockSim

    kw = dict(steps=40, bootstrap_steps=20, kp=0.4, ki=0.1, kd=0.02)
    engines = [ScriptedEngine(8), ScriptedEngine(8)]
    want = jax_loop(engines[0], JaxSim(camera_hw=(60, 80), seed=1), **kw)
    got = run_closed_loop(engines[1], MockSim(camera_hw=(60, 80), seed=1),
                          out_dir=str(tmp_path), **kw)
    assert _drop_time(got) == _drop_time(want)
    assert engines[1].speeds_in == engines[0].speeds_in and engines[1].warmups == 1
    assert json.loads((tmp_path / "log.json").read_text()) == got
    steers = [entry["steer"] for entry in got]
    assert steers[3] == 0.0 and steers[6] == 0.0 and any(s != 0.0 for s in steers)
    assert got[2]["target_kmh"] == 20.0  # NaN speed in the bootstrap → the start target
    assert got[22]["target_kmh"] == got[21]["speed_kmh"]  # after it → the last speed


# ---------------------------------------------------------------------------
# the engines in the loop
# ---------------------------------------------------------------------------

class Recorder:
    """An engine whose every step's outputs are kept."""

    def __init__(self, engine):
        self.engine, self.preds = engine, []

    def warmup(self):
        self.engine.warmup()

    def infer(self, frame, last_speed_kmh):
        out = self.engine.infer(frame, last_speed_kmh)
        self.preds.append(out)
        return out


@pytest.fixture(scope="module")
def tiny_weights():
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.utils import jit_init

    h, w = MODEL_HW
    init = {k: jnp.zeros((1, 1)) for k in ("speed", "steering", "throttle", "brake")}
    init["image"] = jnp.zeros((1, h, w, 3))
    v = jax.device_get(jit_init(create_automoe_model(TINY, fast_gating_pool=True),
                                jax.random.key(3), init))
    rng = np.random.default_rng(4)
    return {"params": _perturb_norms(v["params"], rng),
            "batch_stats": _perturb_norms(v["batch_stats"], rng)}


def _loop(engine, steps=STEPS):
    from automoe_tpu_torch.infer.run_automoe import run_closed_loop
    from automoe_tpu_torch.infer.sim import MockSim

    rec = Recorder(engine)
    return run_closed_loop(rec, MockSim(camera_hw=CAM_HW, seed=2), steps=steps), rec.preds


@pytest.fixture(scope="module")
def jax_loops(tiny_weights):
    from automoe_tpu.infer.engine import InferenceEngine
    from automoe_tpu.infer.run_automoe import run_closed_loop
    from automoe_tpu.infer.sim import MockSim

    out = {}
    for quantize in (False, True):
        rec = Recorder(InferenceEngine(TINY, tiny_weights, camera_hw=CAM_HW, model_hw=MODEL_HW,
                                       dtype=jnp.float32, quantize=quantize))
        logs = run_closed_loop(rec, MockSim(camera_hw=CAM_HW, seed=2), steps=STEPS)
        out[quantize] = (logs, rec.preds)
    return out


def _port_engine(weights, **kw):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.infer import InferenceEngine

    return InferenceEngine(TINY, state_dict_from_jax(weights, TINY), camera_hw=CAM_HW,
                           model_hw=MODEL_HW, dtype=torch.float32, device="cpu", **kw)


def test_engine_in_the_loop_matches_jax_f32(tiny_weights, jax_loops):
    want, _ = jax_loops[False]
    got, _ = _loop(_port_engine(tiny_weights))
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        for k in ("steer", "throttle", "brake", "speed_kmh"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=(g["step"], k))
        np.testing.assert_allclose(g["expert_weights"], w["expert_weights"], rtol=0,
                                   atol=1e-5, err_msg=g["step"])
    assert want[-1]["speed_kmh"] > 0.0


def test_int8_engine_in_the_loop_tracks_jax(tiny_weights, jax_loops):
    want_logs, want = jax_loops[True]
    logs, got = _loop(_port_engine(tiny_weights, quantize=True))
    assert len(got) == len(want) == STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel_err(w["waypoints"], g["waypoints"]) < 0.03, step
        np.testing.assert_allclose(g["expert_weights"], w["expert_weights"], atol=0.05,
                                   err_msg=step)
    for entry in logs:
        assert np.isfinite([entry["steer"], entry["throttle"], entry["brake"]]).all()
        assert 0 <= entry["throttle"] <= 1 and -1 <= entry["steer"] <= 1


# ---------------------------------------------------------------------------
# CARLA
# ---------------------------------------------------------------------------

def test_carla_image_to_rgb_matches_jax():
    from automoe_tpu.infer.carla_sim import carla_image_to_rgb as jax_rgb

    from automoe_tpu_torch.infer.carla_sim import carla_image_to_rgb

    buf = np.random.default_rng(9).integers(0, 256, (6, 10, 4), dtype=np.uint8)
    image = types.SimpleNamespace(raw_data=buf.tobytes(), height=6, width=10)
    got = carla_image_to_rgb(image)
    np.testing.assert_array_equal(got, jax_rgb(image))
    np.testing.assert_array_equal(got, buf[..., 2::-1])
    assert got.flags["C_CONTIGUOUS"]


@pytest.fixture
def carla_stub(monkeypatch):
    """tests/carla_stub.py as the importable `carla`, for one test."""
    from tests import carla_stub

    monkeypatch.setitem(sys.modules, "carla", types.ModuleType("carla"))  # undone at teardown
    return carla_stub.install()


def test_carla_sim_on_the_stub(carla_stub):
    from automoe_tpu_torch.infer.carla_sim import CarlaSim

    sim = CarlaSim(town=None, fixed_dt=0.1)
    world = sim.world
    assert world._settings.synchronous_mode and world._settings.fixed_delta_seconds == 0.1
    frame = sim.camera_frame()
    assert frame.shape == (600, 800, 3) and frame.dtype == np.uint8
    assert (frame == np.array([30, 20, 10], np.uint8)).all()  # the stub's BGRA (10, 20, 30)
    ticks = world._tick
    sim.tick()
    assert world._tick == ticks + 1
    assert sim.speed_kmh == pytest.approx(18.0)
    sim.apply_control(throttle=2.0, steer=-3.0, brake=-1.0)
    c = sim.vehicle.last_control
    assert (c.throttle, c.steer, c.brake) == (1.0, -1.0, 0.0)
    sim.close()
    assert not world._settings.synchronous_mode and world._settings.fixed_delta_seconds is None
    assert not sim.camera.is_alive and not sim.vehicle.is_alive and not world._sensors


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(module_tmp):
    """The tiny config as a file, and a port checkpoint of it with an EMA."""
    from automoe_tpu_torch.models import create_automoe_model

    root = module_tmp("cli")
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    sds = [create_automoe_model(TINY, device="cpu", seed=s).state_dict() for s in (5, 6)]
    ckpt = root / "best.pt"
    torch.save({"model_state_dict": sds[0], "ema_state_dict": sds[1], "epoch": 1}, ckpt)
    pth = root / "automoe.pth"
    torch.save({"model_state_dict": sds[0]}, pth)
    return {"config": str(cfg), "ckpt": str(ckpt), "pth": str(pth), "sds": sds}


def _main(cli_files, out_dir, *argv):
    from automoe_tpu_torch.infer.run_automoe import main

    return main(["--device", "cpu", "--model-config", cli_files["config"],
                 "--out-dir", str(out_dir), *argv])


def test_cli_mock_writes_log_frames_and_gif(cli_files, tmp_path, capsys):
    summary = _main(cli_files, tmp_path, "--backend", "mock", "--steps", "6", "--save-frames",
                    "--export-gif", "--record-every", "2")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and sorted(summary) == ["final_speed_kmh", "p50_infer_ms",
                                                      "steps"]
    assert summary["steps"] == 6 and summary["p50_infer_ms"] > 0
    logs = json.loads((tmp_path / "log.json").read_text())
    assert len(logs) == 6 and logs[-1]["speed_kmh"] == summary["final_speed_kmh"]
    assert len(list((tmp_path / "frames").glob("frame_*.jpg"))) == 3
    assert (tmp_path / "run.gif").stat().st_size > 0


def test_cli_carla_backend_on_the_stub(cli_files, tmp_path, carla_stub):
    summary = _main(cli_files, tmp_path, "--backend", "carla", "--steps", "3")
    assert summary["steps"] == 3 and summary["final_speed_kmh"] == pytest.approx(18.0)


def test_cli_auto_backend_picks_mock_without_carla(cli_files, tmp_path, monkeypatch):
    import automoe_tpu_torch.infer.run_automoe as ra

    monkeypatch.setitem(sys.modules, "carla", None)  # `import carla` raises ImportError
    assert not ra._carla_available()
    made = []

    class Mock(ra.MockSim):
        def __init__(self, **kw):
            made.append(kw)
            super().__init__(**kw)

    monkeypatch.setattr(ra, "MockSim", Mock)
    assert _main(cli_files, tmp_path, "--steps", "2", "--fixed-dt", "0.1")["steps"] == 2
    assert made == [{"fixed_dt": 0.1}]


@pytest.mark.parametrize("argv,message", [
    (["--ema"], "--ema needs --checkpoint"),
    (["--ema", "--checkpoint", "PTH"], "not a .pth"),
    (["--checkpoint", "MISSING"], "no such file"),
], ids=["ema-without-checkpoint", "ema-with-pth", "missing-checkpoint"])
def test_cli_checkpoint_rules(cli_files, tmp_path, argv, message):
    argv = [{"PTH": cli_files["pth"], "MISSING": str(tmp_path / "none.pt")}.get(a, a)
            for a in argv]
    with pytest.raises(SystemExit, match=message):
        _main(cli_files, tmp_path, "--backend", "mock", "--steps", "1", *argv)


def test_cli_serves_the_checkpoints_weights(cli_files, tmp_path):
    """--checkpoint of a port checkpoint drives the loop as an engine on its
    weights does; --ema, as one on its EMA weights."""
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.infer.run_automoe import run_closed_loop
    from automoe_tpu_torch.infer.sim import MockSim

    for i, extra in enumerate(([], ["--ema"])):
        out = tmp_path / str(i)
        _main(cli_files, out, "--backend", "mock", "--steps", "3", "--checkpoint",
              cli_files["ckpt"], *extra)
        engine = InferenceEngine(TINY, cli_files["sds"][i], device="cpu")
        want = run_closed_loop(engine, MockSim(), steps=3)
        assert _drop_time(json.loads((out / "log.json").read_text())) == _drop_time(want)


def test_cli_raises_without_a_gpu(cli_files, tmp_path, monkeypatch):
    from automoe_tpu_torch.infer.run_automoe import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--model-config", cli_files["config"], "--backend", "mock", "--steps", "1",
              "--out-dir", str(tmp_path)])
