"""The reference's staged program end to end in one process, with a
checkpoint handoff across every pipeline boundary (port of
automoe_tpu/tools/campaign.py).

The reference product is a 7-stage chain of bash launchers (README.md:
48-62): collect -> preprocess -> BDD expert training -> CARLA fine-tune
-> policy -> gating (loading the fine-tuned expert checkpoints,
training/train_gating_network.sh:27-33) -> closed-loop inference. Each
stage's output is the next stage's input. This runner executes it at
reduced-but-honest scale (256² frames, real loaders, the real Trainer,
the real eval CLI, the real export / int8 / serving stack) on one device
and ledgers per-stage wall-clock seconds, key metrics and the hand-written
kernels' launches to <out>/campaign.json.

Stages (each timed; checkpoint arrows are actual file handoffs):
  data      synth raw CARLA episodes -> the real preprocess_carla;
            synth BDD caches (tools/synth.py writes the reference's
            formats with learnable structure)
  experts   bdd detection/drivable/segmentation
  finetune  carla det/seg/drv  [warm start: --init-from the experts' best]
            + nuscenes-2d
  policy    standalone trajectory policy
  gating    --expert-ckpts <4 finetune bests> --cache-expert-features
            [--device-resident]
  eval      the eval CLI's gating over the trained gating best + curves
  export    save_serving_bundle (bf16) + int8 PTQ calibrated on real val
            frames, bf16 against int8 on one frame
  serve     BatchingServer soak on the trained engine with 20 Hz clients
            (a client's failed request is counted in the ledger, and the
            stage raises after its row is written)
            + the closed loop on MockSim with the trained weights

On the card the path runs K1 (and K2 on escalation) in every detection
step of `experts` and `finetune`, K2 alone in every nuscenes-2d step, and
K3 in the export stage's int8 frame; each train call's launches are in
its ledger row (`kernel_launches`).

Differences from the JAX runner: `--device` (default cuda) names the
device, and the runner raises at start when CUDA is asked for and there
is none; `--smoke` only shrinks the sizes (64² frames, tiny counts) and
never changes the device; checkpoints are the port's
<ckpt-root>/<workload>/<run>/best.pt; the engines come from
`InferenceEngine.from_torch_checkpoint`; the CARLA caches are written at
--image-size; the ledger is replaced atomically (a temporary file, then
os.replace); the int8 calibration frames are the val images with their
ImageNet normalisation undone (JAX scales the normalised images, which
clips them to 0 and 255), and the int8-vs-bf16 control is taken on a val
frame outside the calibration set (JAX's is a calibration frame).

    python -m automoe_tpu_torch.tools.campaign [--out runs/campaign_torch]
        [--image-size 256] [--device cuda] [--smoke] [--skip data,experts,...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List

STAGES = ("data", "experts", "finetune", "policy", "gating", "eval", "export", "serve")


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class Ledger:
    def __init__(self, out: Path):
        self.path = out / "campaign.json"
        # resume semantics: --skip re-runs load the existing ledger so
        # skipped stages keep their rows and re-run stages overwrite
        # theirs in place (the final file is always the full chain)
        if self.path.exists():
            self.rec: Dict = json.loads(self.path.read_text())
        else:
            self.rec = {"stages": {}, "order": []}

    def write(self) -> None:
        tmp = self.path.with_name(self.path.name + ".tmp")
        tmp.write_text(json.dumps(self.rec, indent=1))
        os.replace(tmp, self.path)

    def stage(self, name: str, result: Dict, wall_s: float):
        self.rec["stages"][name] = {
            "wall_s": round(wall_s, 1),
            **{k: _jsonable(v) for k, v in result.items()},
        }
        if name not in self.rec["order"]:
            self.rec["order"].append(name)
        self.write()
        print(f"[campaign] <<< {name} done in {wall_s:.1f}s: "
              f"{json.dumps({k: _jsonable(v) for k, v in result.items()})[:400]}",
              flush=True)


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' launch counts so far (K1 + K2:
    auction_solve; K3: s2d_stem_pool_int8[_f32]; K4: maxpool3x3s2_int8)."""
    from automoe_tpu_torch.ops import auction_kernel, stem

    return {**auction_kernel.LAUNCHES, **stem.LAUNCHES}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in kernel_launches().items()
            if v != before.get(k, 0)}


def _train(argv: List[str]) -> Dict:
    from automoe_tpu_torch.train.cli import main as train_main

    print(f"[campaign] train {' '.join(argv)}", flush=True)
    before = kernel_launches()
    res = train_main(argv) or {}
    return {**{k: _jsonable(v) for k, v in res.items()}, "kernel_launches": _since(before)}


def camera_frames(images, camera_hw):
    """u8 camera frames [N,H,W,3] of `camera_hw` from the loader's
    ImageNet-normalised NHWC images: the normalisation is undone before the
    frames are scaled to u8 and resized to the camera's size."""
    import numpy as np
    from PIL import Image

    from automoe_tpu_torch.tools.preprocess_carla import IMAGENET_MEAN, IMAGENET_STD

    rgb = np.asarray(images, np.float32) * IMAGENET_STD + IMAGENET_MEAN
    u8 = np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)
    return np.stack([np.array(Image.fromarray(f).resize((camera_hw[1], camera_hw[0])))
                     for f in u8])


def model_config_dict() -> Dict:
    from automoe_tpu_torch.configs import default_model_config

    return dataclasses.asdict(default_model_config())


def main(argv=None):
    p = argparse.ArgumentParser("automoe-campaign-torch")
    p.add_argument("--out", default="runs/campaign_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda; 'cpu' runs without a "
                        "GPU)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--bdd-train", type=int, default=256)
    p.add_argument("--bdd-val", type=int, default=32)
    p.add_argument("--carla-runs", type=int, default=5)
    p.add_argument("--carla-frames", type=int, default=64)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--epochs-experts", type=int, default=2)
    p.add_argument("--epochs-finetune", type=int, default=2)
    p.add_argument("--epochs-policy", type=int, default=3)
    p.add_argument("--epochs-gating", type=int, default=4)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="scan-group K for the gating stage")
    p.add_argument("--device-resident", action="store_true",
                   help="gating trains from the device-resident cached working set "
                        "(needs the feature cache)")
    p.add_argument("--no-warm-start", action="store_true",
                   help="fine-tune from scratch init like the reference "
                        "(ImageNet weights are not loadable here) instead "
                        "of from the BDD expert checkpoints")
    p.add_argument("--skip", default="",
                   help="comma-separated stage names to skip (their "
                        "artifacts must already exist under --out)")
    p.add_argument("--serve-seconds", type=float, default=12.0)
    p.add_argument("--serve-clients", type=int, default=8)
    p.add_argument("--loop-steps", type=int, default=20)
    p.add_argument("--smoke", action="store_true",
                   help="plumbing check: 64² images, tiny counts (the device stays "
                        "--device's)")
    args = p.parse_args(argv)

    import torch

    from automoe_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[campaign] device: {dev} ({name})", flush=True)

    if args.smoke:
        args.image_size = 64
        args.batch_size = 4
        args.bdd_train, args.bdd_val = 8, 4
        args.carla_runs, args.carla_frames = 2, 12
        args.horizon = 4
        args.epochs_experts = args.epochs_finetune = 1
        args.epochs_policy = args.epochs_gating = 1
        args.serve_seconds = 2.0
        args.serve_clients = 2
        args.loop_steps = 4

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    skip = set(filter(None, args.skip.split(",")))
    unknown = skip - set(STAGES)
    if unknown:
        raise SystemExit(f"--skip: unknown stages {sorted(unknown)} (stages: {STAGES})")
    ledger = Ledger(out)
    ledger.rec["device"] = {"type": dev.type, "name": name}
    S = args.image_size
    ckpt_root = str(out / "ckpt")
    runs_root = str(out / "runs")
    bdd_root = out / "data" / "bdd"
    raw_root = out / "data" / "carla_raw"
    pre_root = out / "data" / "carla_pre"

    common = [
        "--batch-size", str(args.batch_size),
        "--num-workers", str(args.num_workers),
        "--image-size", str(S),
        "--ckpt-root", ckpt_root, "--runs-root", runs_root,
        "--device", args.device,
    ]

    # config file shared by gating training, eval, and serving
    cfg_path = out / "model_config.json"
    cfg_path.write_text(json.dumps(model_config_dict(), indent=1))

    # ---------------- data ----------------
    if "data" not in skip:
        t0 = time.time()
        from automoe_tpu_torch.tools import preprocess_carla as prep
        from automoe_tpu_torch.tools.synth import synth_bdd, synth_raw_carla

        n_bdd = {"train": args.bdd_train, "val": args.bdd_val}
        for task in ("detection", "segmentation", "drivable"):
            synth_bdd(bdd_root, task=task, n_per_split=n_bdd, size=S)
        runs = tuple(f"run_{i + 1:03d}" for i in range(args.carla_runs))
        synth_raw_carla(raw_root, runs=runs, n_frames=args.carla_frames)
        prep.main(["--raw_dir", str(raw_root), "--out_dir", str(pre_root),
                   "--out_size", str(S)])
        n_train_runs = len(list((pre_root / "train").iterdir()))
        n_val_runs = len(list((pre_root / "val").iterdir()))
        ledger.stage("data", {
            "bdd_per_task": n_bdd, "carla_runs": len(runs),
            "carla_frames_per_run": args.carla_frames,
            "pre_train_runs": n_train_runs, "pre_val_runs": n_val_runs,
            "image_size": S,
        }, time.time() - t0)

    # ---------------- experts (BDD) ----------------
    if "experts" not in skip:
        t0 = time.time()
        res = {}
        for task in ("detection", "drivable", "segmentation"):
            t1 = time.time()
            r = _train([
                "bdd", "--task", task,
                "--data-root", str(bdd_root / task),
                "--epochs", str(args.epochs_experts),
                "--run-name", "campaign_bdd", *common,
            ])
            res[task] = {"best_val_loss": r.get("best_val_loss"),
                         "kernel_launches": r["kernel_launches"],
                         "wall_s": round(time.time() - t1, 1)}
        ledger.stage("experts", res, time.time() - t0)

    # ---------------- CARLA fine-tune ----------------
    if "finetune" not in skip:
        t0 = time.time()
        res = {}
        for task in ("detection", "segmentation", "drivable"):
            t1 = time.time()
            cmd = [
                "finetune-carla", "--task", task,
                "--data-root", str(pre_root),
                "--epochs", str(args.epochs_finetune),
                "--run-name", "campaign_ft", *common,
            ]
            if not args.no_warm_start:
                cmd += ["--init-from", f"{ckpt_root}/bdd_{task}/campaign_bdd/best.pt"]
            r = _train(cmd)
            res[task] = {"best_val_loss": r.get("best_val_loss"),
                         "warm_start": not args.no_warm_start,
                         "kernel_launches": r["kernel_launches"],
                         "wall_s": round(time.time() - t1, 1)}
        t1 = time.time()
        r = _train([
            "nuscenes-2d", "--data-root", str(pre_root),
            "--epochs", str(args.epochs_finetune),
            "--run-name", "campaign_ft", *common,
        ])
        res["nuscenes_2d"] = {"best_val_loss": r.get("best_val_loss"),
                              "kernel_launches": r["kernel_launches"],
                              "wall_s": round(time.time() - t1, 1)}
        ledger.stage("finetune", res, time.time() - t0)

    # ---------------- policy ----------------
    if "policy" not in skip:
        t0 = time.time()
        r = _train([
            "policy", "--data-root", str(pre_root),
            "--epochs", str(args.epochs_policy),
            "--horizon", str(args.horizon),
            "--run-name", "campaign", *common,
        ])
        ledger.stage("policy", {"best_val_loss": r.get("best_val_loss")}, time.time() - t0)

    # ---------------- gating (checkpoint handoff) ----------------
    expert_ckpts = ",".join([
        f"{ckpt_root}/bdd_detection/campaign_ft/best.pt",
        f"{ckpt_root}/bdd_segmentation/campaign_ft/best.pt",
        f"{ckpt_root}/bdd_drivable/campaign_ft/best.pt",
        f"{ckpt_root}/carla_nuscenes_2d/campaign_ft/best.pt",
    ])
    gating_best = f"{ckpt_root}/gating/campaign/best.pt"
    if "gating" not in skip:
        t0 = time.time()
        cmd = [
            "gating", "--data-root", str(pre_root),
            "--model-config", str(cfg_path),
            "--expert-ckpts", expert_ckpts,
            "--cache-expert-features",
            "--feature-cache-dir", str(out / "feature_cache"),
            "--epochs", str(args.epochs_gating),
            "--run-name", "campaign", *common,
        ]
        if args.steps_per_call > 1:
            cmd += ["--steps-per-call", str(args.steps_per_call)]
        if args.device_resident:
            cmd += ["--device-resident"]
        r = _train(cmd)
        ledger.stage("gating", {
            "best_val_loss": r.get("best_val_loss"),
            "expert_ckpts": expert_ckpts.split(","),
            "device_resident": args.device_resident,
        }, time.time() - t0)

    # ---------------- eval ----------------
    if "eval" not in skip:
        t0 = time.time()
        from automoe_tpu_torch.evals.cli import main as eval_main

        res = eval_main([
            "gating", "--model-config", str(cfg_path),
            "--checkpoint", gating_best,
            "--data-root", str(pre_root), "--split", "val",
            "--batch-size", str(args.batch_size),
            "--num-workers", "1",
            "--image-size", str(S),
            "--out-dir", str(out / "eval_out"),
            "--device", args.device,
        ])
        eval_main([
            "training-curves", "--run-dir", f"{runs_root}/gating_campaign",
        ])
        keep = {k: round(float(v), 4) for k, v in res.items()
                if isinstance(v, (int, float))}
        ledger.stage("eval", keep, time.time() - t0)

    camera_hw = (600, 800) if not args.smoke else (120, 160)

    def engine(**kw):
        from automoe_tpu_torch.infer.engine import InferenceEngine

        return InferenceEngine.from_torch_checkpoint(
            str(cfg_path), gating_best, camera_hw=camera_hw, model_hw=(S, S),
            dtype=torch.bfloat16, device=args.device, **kw)

    # ---------------- export + int8 PTQ ----------------
    bundle_dir = out / "bundle"
    if "export" not in skip:
        t0 = time.time()
        import numpy as np

        from automoe_tpu_torch.data import get_carla_sequence_loader
        from automoe_tpu_torch.infer.controllers import pure_pursuit_steer
        from automoe_tpu_torch.serving.export import save_serving_bundle

        # calibration frames: the first val batch of the preprocessed set;
        # the control frame: the last val frame, which is not among them
        val_loader = get_carla_sequence_loader(
            split="val", root_dir=str(pre_root), batch_size=2,
            num_workers=1, shuffle=False, horizon=args.horizon,
        )
        batches = [np.asarray(b["image"]) for b in val_loader]
        if len(batches) < 2:
            raise RuntimeError("export: the val split needs a frame beyond the "
                               "calibration batch")
        calib = camera_frames(batches[0], camera_hw)
        f0 = camera_frames(batches[-1][-1:], camera_hw)
        before = kernel_launches()
        eng = engine()
        t_b = time.time()
        save_serving_bundle(eng, bundle_dir, buckets=(1, 8))
        bundle_s = time.time() - t_b
        t_q = time.time()
        engine_q = engine(quantize=True, calib_frames=calib)
        quant_s = time.time() - t_q
        # bf16 against int8 on a val frame outside the calibration set:
        # model outputs (waypoints / target speed) plus the derived steer
        # command (the controllers are deterministic given the outputs)
        o_bf = eng.infer(f0, 30.0)
        o_q = engine_q.infer(f0, 30.0)
        dev_abs = {
            k: float(np.max(np.abs(
                np.asarray(o_bf[k], np.float32)
                - np.asarray(o_q[k], np.float32)
            )))
            for k in ("waypoints", "speed")
        }
        dev_abs["steer_cmd"] = float(abs(
            pure_pursuit_steer(np.asarray(o_bf["waypoints"][0]))
            - pure_pursuit_steer(np.asarray(o_q["waypoints"][0]))
        ))
        ledger.stage("export", {
            "bundle_save_s": round(bundle_s, 1),
            "int8_calibrate_s": round(quant_s, 1),
            "int8_vs_bf16_max_abs_controls": dev_abs,
            "bundle_dir": str(bundle_dir),
            "kernel_launches": _since(before),
        }, time.time() - t0)
        del engine_q, eng

    # ---------------- serve ----------------
    if "serve" not in skip:
        t0 = time.time()
        import threading

        import numpy as np

        from automoe_tpu_torch.infer.run_automoe import run_closed_loop
        from automoe_tpu_torch.infer.sim import MockSim
        from automoe_tpu_torch.serving.server import BatchingServer

        eng = engine()
        eng.warmup()
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 256, (*camera_hw, 3), dtype=np.uint8)
        lat, errors, lock = [], [], threading.Lock()
        stop = threading.Event()
        with BatchingServer(eng, max_batch=32, max_wait_ms=8.0) as srv:
            def client(cid):
                my, err = [], None
                period = 1.0 / 20.0
                next_t = time.perf_counter() + cid * period / 16
                while not stop.is_set():
                    now = time.perf_counter()
                    if now < next_t:
                        time.sleep(min(next_t - now, 0.01))
                        continue
                    next_t += period
                    t1 = time.perf_counter()
                    try:
                        srv.submit(frame, 30.0).result(timeout=20)
                    except Exception as e:  # counted, and raised below
                        err = repr(e)
                        break
                    my.append(time.perf_counter() - t1)
                with lock:
                    lat.extend(my)
                    if err is not None:
                        errors.append(err)

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(args.serve_clients)]
            tw = time.perf_counter()
            for t in ts:
                t.start()
            time.sleep(args.serve_seconds)
            stop.set()
            for t in ts:
                t.join(timeout=25)
            wall = time.perf_counter() - tw
            snap = srv.stats_snapshot()
        arr = np.asarray(lat, np.float64) * 1e3
        serve_rec = {
            "clients": args.serve_clients,
            "achieved_rps": round(len(arr) / wall, 1),
            "e2e_ms_p50": (round(float(np.percentile(arr, 50)), 1)
                           if len(arr) else None),
            "batches": snap.get("batches"),
            "rows_padded": snap.get("rows_padded"),
            "serve_errors": len(errors),
            "serve_first_error": errors[0] if errors else None,
        }

        # the closed loop on MockSim with the trained weights
        sim = MockSim(fixed_dt=0.05, camera_hw=camera_hw)
        logs = run_closed_loop(eng, sim, steps=args.loop_steps, out_dir=str(out / "loop"))
        finite = all(
            np.isfinite([log["steer"], log["throttle"], log["brake"]]).all()
            for log in logs
        )
        serve_rec["closed_loop_steps"] = len(logs)
        serve_rec["closed_loop_finite"] = bool(finite)
        ledger.stage("serve", serve_rec, time.time() - t0)
        if errors or not len(arr):
            raise RuntimeError(f"serve: {len(errors)} of {args.serve_clients} clients failed "
                               f"and {len(arr)} requests were answered; first error: "
                               f"{serve_rec['serve_first_error']}")

    total = sum(s["wall_s"] for s in ledger.rec["stages"].values())
    ledger.rec["total_wall_s"] = round(total, 1)
    ledger.write()
    print(f"[campaign] COMPLETE: {len(ledger.rec['stages'])} stages, "
          f"{total:.0f}s total -> {ledger.path}", flush=True)
    return ledger.rec


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
