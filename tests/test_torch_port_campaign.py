"""The port's staged program and its operations tools on the CPU:

* `tools/supervisor.py` against JAX's `automoe_tpu.tools.supervisor` on
  the same children (the JAX supervisor tests' own) and arguments: the
  return code, every event but its time (and a hang's measured age), the
  argv of every attempt, for a crash relaunched with the resume flags
  after the first attempt, bounded restarts, a hang (stale heartbeat,
  1.5 s timeout) killed by PID and relaunched, and the CLI;
* `tools/launch.py` (`automoe-launch-torch`): `policy-gating` with
  SKIP_GATING on `--device cpu` writes the policy's best.pt and the
  summary under `--log-dir`; a failed stage exits 1 after the summary;
  `--no-mesh` is refused, and without a GPU and without `--device cpu` it
  raises before any stage;
* `tools/checks.py` with no GPU: `check_cuda` reports it and runs no
  matmul; the nuScenes and CARLA scans of what is absent;
* the campaign's int8 calibration frames, the loader's images with their
  normalisation undone;
* `tools/campaign.py --smoke --device cpu` through all eight stages, with
  its ledger, raising without a GPU unless `--device cpu` is given, and
  raising from the serve stage, after its ledger row, when the server's
  requests fail.
The launcher, the checks and the campaign are not run against JAX's: the
JAX launcher and campaign drive the JAX trainer, whose eight stages at
any size exceed this file's time budget, and JAX's checks probe a TPU."""
from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)

# children that crash until a counter file says otherwise, and that hang
# once after one heartbeat (the JAX package's supervisor tests' own)
from tests.test_supervisor import CRASHY, HANGY  # noqa: E402


def _script(root, name, body):
    p = root / name
    p.write_text(body)
    return str(p)


def _events(events, root):
    """The events without their times, with `root` written as <root>."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "heartbeat_age_s")}
        if "cmd" in e:
            e["cmd"] = e["cmd"].replace(str(root), "<root>")
        out.append(e)
    return out


def _crash(Supervisor, root):
    state, argv_log = root / "state", root / "argv.jsonl"
    sup = Supervisor([sys.executable, _script(root, "crashy.py", CRASHY), str(state),
                      str(argv_log)], max_restarts=5, resume_args=["--resume", "full"],
                     backoff_s=0.01, event_log=str(root / "events.jsonl"))
    rc = sup.run()
    logged = [json.loads(line) for line in (root / "events.jsonl").read_text().splitlines()]
    return {"rc": rc, "events": _events(sup.events, root), "logged": _events(logged, root),
            "argv": [json.loads(line) for line in argv_log.read_text().splitlines()]}


def _bounds(Supervisor, root):
    sup = Supervisor([sys.executable, _script(root, "fail.py", "import sys; sys.exit(3)")],
                     max_restarts=2, backoff_s=0.01)
    return {"rc": sup.run(), "events": _events(sup.events, root)}


def _hang(Supervisor, root):
    state, hb = root / "state", root / "heartbeat"
    sup = Supervisor([sys.executable, _script(root, "hangy.py", HANGY), str(state), str(hb)],
                     max_restarts=2, heartbeat_path=str(hb), heartbeat_timeout_s=1.5,
                     backoff_s=0.01, poll_s=0.05, grace_s=2.0)
    rc = sup.run()
    return {"rc": rc, "events": _events(sup.events, root), "attempts": int(state.read_text()),
            "ages": [e["heartbeat_age_s"] for e in sup.events if "heartbeat_age_s" in e]}


def _cli(main, root):
    script = _script(root, "ok.py", "import sys; sys.exit(0)")
    rc = main(["--max-restarts", "1", "--backoff", "0.01", "--event-log",
               str(root / "ev.jsonl"), "--", sys.executable, script])
    with pytest.raises(SystemExit) as e:
        main(["--max-restarts", "1"])  # no child command
    logged = [json.loads(line) for line in (root / "ev.jsonl").read_text().splitlines()]
    return {"rc": rc, "logged": _events(logged, root), "no_child_exit": e.value.code}


CASES = {"crash": _crash, "bounds": _bounds, "hang": _hang}


@pytest.fixture(scope="module")
def jax_supervisor(module_tmp):
    """JAX's supervisor on every case, each in a folder of its own."""
    from automoe_tpu.tools.supervisor import Supervisor, main

    ref = {name: case(Supervisor, module_tmp(f"jax_{name}")) for name, case in CASES.items()}
    ref["cli"] = _cli(main, module_tmp("jax_cli"))
    return ref


def test_supervisor_relaunches_a_crash_with_the_resume_args(jax_supervisor, tmp_path):
    from automoe_tpu_torch.tools.supervisor import Supervisor

    got = _crash(Supervisor, tmp_path)
    assert got == jax_supervisor["crash"]
    assert got["rc"] == 0
    assert got["argv"] == [[], ["--resume", "full"], ["--resume", "full"]]
    assert got["logged"] == got["events"]
    kinds = [e["event"] for e in got["events"]]
    assert kinds.count("failure") == 2 and kinds[-1] == "success"


def test_supervisor_bounds_its_restarts(jax_supervisor, tmp_path):
    from automoe_tpu_torch.tools.supervisor import Supervisor

    got = _bounds(Supervisor, tmp_path)
    assert got == jax_supervisor["bounds"]
    kinds = [e["event"] for e in got["events"]]
    assert got["rc"] == 3 and kinds.count("failure") == 3 and kinds[-1] == "giving_up"


def test_supervisor_kills_a_hang_and_relaunches(jax_supervisor, tmp_path):
    from automoe_tpu_torch.tools.supervisor import Supervisor

    got, ref = _hang(Supervisor, tmp_path), jax_supervisor["hang"]
    assert {k: got[k] for k in ("rc", "events", "attempts")} == \
        {k: ref[k] for k in ("rc", "events", "attempts")}
    assert len(got["ages"]) == len(ref["ages"]) == 1 and got["ages"][0] > 1.5
    kinds = [e["event"] for e in got["events"]]
    assert "hang_detected" in kinds and kinds[-1] == "success"
    assert got["attempts"] == 2  # the hung attempt, then a clean one


def test_supervisor_cli(jax_supervisor, tmp_path):
    from automoe_tpu_torch.tools.supervisor import main

    got = _cli(main, tmp_path)
    assert got == jax_supervisor["cli"]
    assert got["rc"] == 0 and [e["event"] for e in got["logged"]] == ["launch", "success"]


@pytest.fixture(scope="module")
def seq_root(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    return synth_carla_sequence(module_tmp("seq"), n_per_split={"train": 24, "val": 12},
                                size=32, seed=1)


def _launch_argv(root, tmp, *extra):
    return ["policy-gating", "--epochs", "1", "--batch-size", "4", "--image-size", "32",
            "--horizon", "4", "--num-workers", "1", "--data-root", str(root), "--run-name",
            "launchtest", "--ckpt-root", str(tmp / "ckpt"), "--runs-root", str(tmp / "runs"),
            "--log-dir", str(tmp / "logs"), *extra]


def test_launcher_policy_gating_skips_gating(seq_root, tmp_path, monkeypatch, capsys):
    from automoe_tpu_torch.tools.launch import main

    monkeypatch.setenv("SKIP_GATING", "1")
    main(_launch_argv(seq_root, tmp_path, "--device", "cpu"))
    assert (tmp_path / "ckpt" / "carla_policy" / "launchtest" / "best.pt").is_file()
    assert not (tmp_path / "ckpt" / "gating").exists()
    out = capsys.readouterr().out
    assert "[launch] SKIP gating" in out and "policy         ok" in out
    summary = json.loads((tmp_path / "logs" / "policy-gating_launchtest.json").read_text())
    assert [(r["stage"], r["status"]) for r in summary] == [("policy", "ok"),
                                                            ("gating", "skipped")]
    assert summary[0]["seconds"] > 0


def test_launcher_fails_a_stage_and_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """A stage that fails stops the launcher; the mesh flags are forwarded
    to every stage, which refuses a mesh larger than its world with the
    JAX package's words."""
    from automoe_tpu_torch.tools.launch import main

    monkeypatch.setenv("SKIP_GATING", "1")
    with pytest.raises(SystemExit) as e:  # no data: the policy stage fails
        main(_launch_argv(tmp_path / "missing", tmp_path, "--device", "cpu"))
    assert e.value.code == 1 and "policy         FAILED" in capsys.readouterr().out
    summary = json.loads((tmp_path / "logs" / "policy-gating_launchtest.json").read_text())
    assert [r["status"] for r in summary] == ["FAILED"]
    with pytest.raises(SystemExit) as e:
        main(_launch_argv(tmp_path, tmp_path, "--device", "cpu", "--model-axis", "2"))
    said = capsys.readouterr()
    assert e.value.code == 1 and "mesh 1x2 != 1 devices" in said.err + said.out
    assert "policy         FAILED" in said.out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(_launch_argv(tmp_path, tmp_path / "nogpu"))
    assert not (tmp_path / "nogpu").exists()


def test_checks_without_a_gpu(tmp_path, monkeypatch, capsys):
    from automoe_tpu_torch.tools.checks import check_carla, check_cuda, check_nuscenes, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: pytest.fail("counted devices"))
    rep = check_cuda()
    assert rep["cuda_available"] is False and rep["n_devices"] == 0
    assert rep["devices"] == [] and rep["matmul_ok"] is None
    assert main(["cuda"]) == rep
    assert json.loads(capsys.readouterr().out) == rep
    nus = check_nuscenes(str(tmp_path / "nope"), "v1.0-mini")
    assert nus["exists"] is False and nus["tables_present"] is False
    monkeypatch.setitem(sys.modules, "carla", None)  # no client, so no connection attempt
    car = check_carla("127.0.0.1", 2000)
    assert car["client_installed"] is False and car["server_reachable"] is False


def test_campaign_calibration_frames_are_camera_frames(tmp_path):
    """The export stage's int8 calibration frames: a camera frame through
    the CARLA preprocessor and back comes out as itself at model size,
    where JAX's `clip(img * 255)` makes over a third of them 0 or 255."""
    from PIL import Image

    from automoe_tpu_torch.tools.campaign import camera_frames
    from automoe_tpu_torch.tools.preprocess_carla import preprocess_image

    raw = np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    Image.fromarray(raw).save(tmp_path / "frame.png")
    img = preprocess_image(tmp_path / "frame.png", out_size=64).transpose(1, 2, 0)[None]
    got = camera_frames(img, (96, 128))
    model_size = np.array(Image.fromarray(raw).resize((64, 64), Image.BILINEAR))
    want = np.array(Image.fromarray(model_size).resize((128, 96)))
    assert got.shape == (1, 96, 128, 3) and got.dtype == np.uint8
    assert np.abs(got[0].astype(int) - want.astype(int)).max() <= 1
    ends = lambda u8: float(np.isin(u8, (0, 255)).mean())  # noqa: E731
    clipped = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    assert ends(clipped) > 0.3 and ends(got) < 0.01, (ends(clipped), ends(got))


def test_campaign_smoke_on_cpu_runs_all_eight_stages(tmp_path, monkeypatch):
    from automoe_tpu_torch.tools.campaign import STAGES, main

    out = tmp_path / "camp"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--out", str(out)])
    assert not out.exists()
    rec = main(["--smoke", "--device", "cpu", "--out", str(out), "--num-workers", "1",
                "--serve-seconds", "1"])
    assert rec["order"] == list(STAGES)
    assert json.loads((out / "campaign.json").read_text()) == rec
    assert not list(out.glob("*.tmp"))  # the ledger was replaced atomically
    stages = rec["stages"]
    assert stages["data"]["pre_train_runs"] == 1 and stages["data"]["image_size"] == 64
    losses = [stages["experts"][t]["best_val_loss"] for t in
              ("detection", "drivable", "segmentation")]
    losses += [stages["finetune"][t]["best_val_loss"] for t in
               ("detection", "segmentation", "drivable", "nuscenes_2d")]
    losses += [stages[s]["best_val_loss"] for s in ("policy", "gating")]
    assert np.isfinite(losses).all(), losses
    assert all(stages["finetune"][t]["warm_start"] for t in ("detection", "drivable"))
    assert np.isfinite(list(stages["export"]["int8_vs_bf16_max_abs_controls"].values())).all()
    assert (out / "bundle").is_dir()
    serve = stages["serve"]
    assert serve["closed_loop_steps"] == 4 and serve["closed_loop_finite"] is True
    assert serve["batches"] >= 1 and serve["achieved_rps"] > 0
    assert serve["serve_errors"] == 0 and serve["serve_first_error"] is None
    assert (out / "ckpt" / "gating" / "campaign" / "best.pt").is_file()
    assert rec["device"] == {"type": "cpu", "name": "cpu"}

    # the serve stage again on the trained checkpoint, with every request
    # failing: the failures are counted in its row, and the stage raises
    from automoe_tpu_torch.serving.server import BatchingServer

    def broken_submit(self, *a, **kw):
        raise ValueError("broken server")

    monkeypatch.setattr(BatchingServer, "submit", broken_submit)
    with pytest.raises(RuntimeError, match="2 of 2 clients failed"):
        main(["--smoke", "--device", "cpu", "--out", str(out), "--num-workers", "1",
              "--serve-seconds", "0.5", "--skip", ",".join(STAGES[:-1])])
    serve = json.loads((out / "campaign.json").read_text())["stages"]["serve"]
    assert serve["serve_errors"] == 2 and "broken server" in serve["serve_first_error"]
    assert serve["achieved_rps"] == 0
