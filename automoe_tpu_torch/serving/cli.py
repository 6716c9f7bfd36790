"""`automoe-serve-torch`: TCP micro-batching model server on the PyTorch
port (serving/server.py; `serving.Client` is the reference client).

  automoe-serve-torch --bundle exported_bundle/    # cold start: the exported
                                                   # programs only (serving/export.py)
  automoe-serve-torch --checkpoint automoe.pth     # reference torch ckpt
  automoe-serve-torch --checkpoint checkpoints/gating/run/best.pt --quantize
                                                   # a checkpoint automoe-train-torch wrote
  automoe-serve-torch --checkpoint checkpoints/gating/run/best.pt --ema
                                                   # its EMA weights (--ema-decay runs)
  automoe-serve-torch --quantize                   # int8 trunks, random init
  automoe-serve-torch --device cpu                 # no GPU
  automoe-serve-torch --data-parallel --quantize   # a replica on every visible card

Runs on `cuda` unless --device names another device; a bundle runs on
the device it was traced on.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence


def load_engine(model_config, checkpoint: Optional[str], ema: bool, **kw):
    """The engine of the entry points' --model-config, --checkpoint and
    --ema: a reference `.pth` or a checkpoint written by
    `automoe-train-torch`; --ema needs the latter. `kw` goes to
    InferenceEngine."""
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer.engine import InferenceEngine

    cfg = model_config or default_model_config()
    if checkpoint:
        if not Path(checkpoint).is_file():
            raise SystemExit(f"--checkpoint {checkpoint}: no such file")
        if ema and checkpoint.endswith(".pth"):
            raise SystemExit("--ema needs a checkpoint written by an automoe-train-torch "
                             "run with --ema-decay (not a .pth)")
        return InferenceEngine.from_torch_checkpoint(cfg, checkpoint, prefer_ema=ema, **kw)
    if ema:
        raise SystemExit("--ema needs --checkpoint")
    return InferenceEngine(cfg, **kw)


def build_engine(args):
    if args.bundle:
        if args.ema:
            raise SystemExit("--ema applies at export time for bundles: pass prefer_ema "
                             "when building the bundle's engine instead")
        if args.data_parallel:
            raise SystemExit("--data-parallel needs a live model (the bundle's exported "
                             "programs run on the one device they were traced on) — use "
                             "--checkpoint/--model-config")
        from automoe_tpu_torch.serving.export import ArtifactEngine

        return ArtifactEngine(args.bundle)

    import torch

    kw = {"device": args.device}
    if args.data_parallel:  # one replica a visible card
        from automoe_tpu_torch.utils import resolve_device

        dev = resolve_device(args.device)
        kw = {"devices": ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                          if dev.type == "cuda" else [dev])}
    return load_engine(
        args.model_config, args.checkpoint, args.ema,
        camera_hw=tuple(args.camera_hw),
        model_hw=tuple(args.model_hw),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        quantize=args.quantize,
        **kw,
    )


def main(argv: Optional[Sequence[str]] = None, block: bool = True):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bundle", default=None,
                   help="save_serving_bundle dir: serve its exported programs, no model "
                        "code or calibration at start-up; they run on the device they were "
                        "traced on (--device is ignored)")
    p.add_argument("--model-config", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="AutoMoE torch checkpoint: a reference .pth or a gating checkpoint "
                        "written by automoe-train-torch")
    p.add_argument("--quantize", action="store_true",
                   help="int8 PTQ expert trunks (serving/quant.py)")
    p.add_argument("--ema", action="store_true",
                   help="serve the EMA weights from a --ema-decay run's checkpoint "
                        "(the deploy-side weights)")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--camera-hw", type=int, nargs=2, default=(600, 800))
    p.add_argument("--model-hw", type=int, nargs=2, default=(256, 256))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help=">=2 overlaps the next batch's upload and enqueue "
                        "with the current batch's device step and fetch; "
                        "1 = serial worker. Engines without dispatch_batch "
                        "(--bundle) fall back to serial")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run without a GPU); "
                        "ignored with --bundle")
    p.add_argument("--data-parallel", action="store_true",
                   help="one replica of the model on every visible card, each request "
                        "batch split over them (repeat-padded to a multiple of the cards): "
                        "InferenceEngine(devices=...)")
    args = p.parse_args(argv)

    from automoe_tpu_torch.serving.server import BatchingServer, serve_tcp

    engine = build_engine(args)
    buckets = getattr(engine, "buckets", None)  # a bundle pins them
    max_batch = min(args.max_batch, max(buckets)) if buckets else args.max_batch
    batcher = BatchingServer(
        engine, max_batch=max_batch, max_wait_ms=args.max_wait_ms,
        buckets=buckets, pipeline_depth=args.pipeline_depth,
    ).start()
    srv = serve_tcp(batcher, host=args.host, port=args.port)
    host, port = srv.server_address[:2]
    print(json.dumps({"serving": True, "host": host, "port": port,
                      "max_batch": batcher.max_batch,
                      "buckets": batcher.buckets}), flush=True)
    if not block:
        return srv, batcher
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        batcher.close()


if __name__ == "__main__":
    main()
