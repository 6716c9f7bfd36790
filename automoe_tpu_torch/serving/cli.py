"""`automoe-serve-torch`: TCP micro-batching model server on the PyTorch
port (serving/server.py; `serving.Client` is the reference client).

  automoe-serve-torch --checkpoint automoe.pth     # reference torch ckpt
  automoe-serve-torch --checkpoint checkpoints/gating/run/best.pt --quantize
                                                   # a checkpoint automoe-train-torch wrote
  automoe-serve-torch --quantize                   # int8 trunks, random init
  automoe-serve-torch --device cpu                 # no GPU

Runs on `cuda` unless --device names another device.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence


def build_engine(args):
    import torch

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer.engine import InferenceEngine

    cfg = args.model_config or default_model_config()
    kw = dict(
        camera_hw=tuple(args.camera_hw),
        model_hw=tuple(args.model_hw),
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
        quantize=args.quantize,
        device=args.device,
    )
    if args.checkpoint:
        if not Path(args.checkpoint).is_file():
            raise SystemExit(f"--checkpoint {args.checkpoint}: no such file")
        return InferenceEngine.from_torch_checkpoint(cfg, args.checkpoint, **kw)
    return InferenceEngine(cfg, **kw)


def main(argv: Optional[Sequence[str]] = None, block: bool = True):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-config", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="AutoMoE torch checkpoint: a reference .pth or a gating checkpoint "
                        "written by automoe-train-torch")
    p.add_argument("--quantize", action="store_true",
                   help="int8 PTQ expert trunks (serving/quant.py)")
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
                        "1 = serial worker")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run without a GPU)")
    args = p.parse_args(argv)

    from automoe_tpu_torch.serving.server import BatchingServer, serve_tcp

    engine = build_engine(args)
    batcher = BatchingServer(
        engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        pipeline_depth=args.pipeline_depth,
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
