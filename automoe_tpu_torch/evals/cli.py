"""`automoe-eval-torch`: the evaluation CLI of the port (port of
automoe_tpu/evals/cli.py; counterparts of the reference's
eval/evaluate_bdd100k_expert.py, evaluate_nuscenes_expert.py,
evaluate_gating_network.py, visualize_bdd100k_detection.py and
analyze_bdd100k_detection_batch.py). Writes timestamped JSON under
<out-dir>/results and plots under <out-dir>/vis.

  automoe-eval-torch bdd --task detection --checkpoint ckpt/bdd_detection/run/best.pt
  automoe-eval-torch bdd --task drivable --source carla --quantize
  automoe-eval-torch nuscenes --checkpoint ckpt/nuscenes/run/best.pt
  automoe-eval-torch gating --checkpoint ckpt/gating/run/best.pt --quantize
  automoe-eval-torch training-curves --run-dir runs/bdd_detection_run
  automoe-eval-torch visualize-detection --source carla --max-images 8

Checkpoints are the port's (`automoe-train-torch`); without --checkpoint
a seeded init is evaluated. --quantize evaluates through the int8 serving
path at float32, calibrated on the first val batch. The model runs on
`cuda` unless --device names another device.
"""
from __future__ import annotations

import argparse
import datetime as _dt
import functools
import json
from pathlib import Path

import numpy as np


def _timestamped(out_dir: str, name: str) -> Path:
    ts = _dt.datetime.now().strftime("%Y%m%d_%H%M%S")
    p = Path(out_dir) / "results"
    p.mkdir(parents=True, exist_ok=True)
    return p / f"{name}_{ts}.json"


def _load_model(build_model, ckpt_path, device):
    """The module from seed 0, then the checkpoint's weights and
    statistics (ckpt/checkpoint.py::load_variables), in eval mode."""
    import torch

    from automoe_tpu_torch.ckpt.checkpoint import load_variables
    from automoe_tpu_torch.models.automoe import init_parameters

    model = build_model()
    init_parameters(model, torch.Generator().manual_seed(0))
    if ckpt_path:
        load_variables(ckpt_path, model)
    return model.to(device).eval()


def cmd_bdd(args):
    import torch

    from automoe_tpu_torch.data import (
        get_bdd_detection_loader,
        get_bdd_drivable_loader,
        get_bdd_segmentation_loader,
        get_carla_detection_loader,
        get_carla_drivable_loader,
        get_carla_segmentation_loader,
    )
    from automoe_tpu_torch.evals import evaluate_detection, evaluate_seg_like
    from automoe_tpu_torch.train.workloads import bdd_expert_workload
    from automoe_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    source = {
        ("bdd", "detection"): get_bdd_detection_loader,
        ("bdd", "segmentation"): get_bdd_segmentation_loader,
        ("bdd", "drivable"): get_bdd_drivable_loader,
        ("carla", "detection"): get_carla_detection_loader,
        ("carla", "segmentation"): get_carla_segmentation_loader,
        ("carla", "drivable"): get_carla_drivable_loader,
    }[(args.source, args.task)]
    kw = {"box_cap": args.box_cap} if args.task == "detection" else {}
    if args.data_root:
        kw["root_dir"] = args.data_root
    loader = source(split=args.split, batch_size=args.batch_size,
                    num_workers=args.num_workers, shuffle=False, **kw)
    wl = bdd_expert_workload(args.task)
    model = _load_model(wl.build_model, args.checkpoint, dev)
    forward = model
    if args.quantize:
        # int8 task-metric fidelity: the same eval through the int8 serving
        # trunk, calibrated on the first val batch, at float32
        from automoe_tpu_torch.serving.quant import (
            make_expert_quant_apply,
            prepare_qexpert,
            quantize_expert,
        )

        calib = next(iter(loader))
        qpack, qscales = quantize_expert(model, [calib["image"]], dtype=torch.float32)
        apply_fn = make_expert_quant_apply(args.task, model.num_classes, qscales,
                                           dtype=torch.float32)
        forward = functools.partial(apply_fn, model,
                                    prepare_qexpert(qpack, qscales, torch.float32, dev))
    if args.task == "detection":
        res = evaluate_detection(forward, loader, num_classes=model.num_classes, device=dev)
    else:
        res = evaluate_seg_like(forward, loader, num_classes=model.num_classes, device=dev)
    res["quantized"] = bool(args.quantize)
    path = _timestamped(args.out_dir, f"{args.source}_{args.task}")
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps(res))
    return res


def cmd_nuscenes(args):
    from automoe_tpu_torch.ckpt.checkpoint import load_checkpoint
    from automoe_tpu_torch.data import get_nuscenes_loader
    from automoe_tpu_torch.evals import evaluate_nuscenes
    from automoe_tpu_torch.train.workloads import nuscenes_workload
    from automoe_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    kw = {"root_dir": args.data_root} if args.data_root else {}
    loader = get_nuscenes_loader(split=args.split, batch_size=args.batch_size,
                                 num_workers=args.num_workers, shuffle=False, **kw)
    # the JAX CLI's default expert (camera + LiDAR, concat, 100 queries),
    # with its TNets when the checkpoint has them: the JAX CLI would build
    # the expert without them and drop a --use-tnet run's TNet weights
    tnet = bool(args.checkpoint) and any(
        k.startswith("lidar_backbone.input_transform.")
        for k in load_checkpoint(args.checkpoint)["model_state_dict"])
    model = _load_model(nuscenes_workload(use_tnet=tnet).build_model, args.checkpoint, dev)
    res = evaluate_nuscenes(model, loader)
    path = _timestamped(args.out_dir, "nuscenes_expert")
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps(res))
    return res


def cmd_gating(args):
    import torch

    from automoe_tpu_torch.configs import default_model_config, load_model_config
    from automoe_tpu_torch.data import get_carla_sequence_loader
    from automoe_tpu_torch.evals import evaluate_automoe
    from automoe_tpu_torch.evals.gating import context_gating_correlation
    from automoe_tpu_torch.evals.plots import plot_correlation_heatmap, plot_expert_usage
    from automoe_tpu_torch.models.automoe import AutoMoE
    from automoe_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    cfg = (load_model_config(args.model_config) if args.model_config
           else default_model_config())
    kw = {"root_dir": args.data_root} if args.data_root else {}
    loader = get_carla_sequence_loader(
        split=args.split, batch_size=args.batch_size,
        num_workers=args.num_workers, shuffle=False,
        horizon=cfg.policy.num_waypoints, **kw,
    )
    # the int8 forward pools seg/drivable logits at low res (exactly the
    # mean of the upsampled map): build the model so
    model = _load_model(functools.partial(AutoMoE, cfg, fast_gating_pool=args.quantize),
                        args.checkpoint, dev)
    forward = model
    if args.quantize:
        # PTQ accuracy: the same metrics through the int8 serving path at
        # float32 (its stem is K3's f32 kernel on the card), calibrated on
        # the first val batch
        from automoe_tpu_torch.serving.quant import (
            make_quant_forward,
            prepare_qexperts,
            quantize_automoe,
        )

        calib = next(iter(loader))
        qpack = quantize_automoe(model, [{"image": torch.as_tensor(calib["image"], device=dev)}],
                                 dtype=torch.float32)
        qfwd = make_quant_forward(cfg, qpack["scales"], dtype=torch.float32)
        forward = functools.partial(qfwd, model, prepare_qexperts(qpack, torch.float32, dev))
    res = evaluate_automoe(forward, loader, device=dev)
    res["quantized"] = bool(args.quantize)

    expert_names = [e.type for e in cfg.experts]
    vis = Path(args.out_dir) / "vis"
    plot_expert_usage(res["expert_usage"], res["expert_std"], expert_names,
                      str(vis / "expert_usage.png"))
    # context <-> gating correlation over the rows evaluate_automoe
    # collected (real rows only): no second pass over the eval set
    ctx_rows = np.asarray(res["context_rows"])
    gate_rows = np.asarray(res["gate_logits"] if args.use_logits else res["expert_weights"])
    if ctx_rows.size:
        corr = context_gating_correlation(
            ctx_rows, gate_rows, use_logits=args.use_logits,
            context_names=["speed", "steering", "throttle", "brake"],
            expert_names=expert_names,
        )
        for kind in ("pearson", "spearman"):
            plot_correlation_heatmap(
                corr[kind], corr["context_names"], corr["expert_names"],
                f"Context vs Expert Correlation ({kind.title()})",
                str(vis / f"context_corr_{kind}.png"),
            )
        res["correlation"] = {k: corr[k].tolist() for k in ("pearson", "spearman")}

    for k in ("expert_weights", "gate_logits", "context_rows"):
        res.pop(k, None)
    path = _timestamped(args.out_dir, "gating")
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps({k: v for k, v in res.items() if k != "correlation"}))
    return res


def cmd_training_curves(args):
    """Training curves from a run's metrics.jsonl (the reference's
    plot_training_curves, eval/evaluate_gating_network.py:135-167)."""
    from automoe_tpu_torch.evals.plots import plot_training_curves

    run_dir = Path(args.run_dir)
    out = args.out or str(run_dir / "training_curves.png")
    tags = args.tags.split(",") if args.tags else None
    plotted = plot_training_curves(str(run_dir / "metrics.jsonl"), out, tags=tags)
    print(f"Training curves plot saved to {out}")
    return {"plot": out, "tags": plotted}


def cmd_visualize(args):
    """GT-vs-prediction overlays and the per-image analysis table
    (counterpart of eval/visualize_bdd100k_detection.py and
    analyze_bdd100k_detection_batch.py)."""
    import torch

    from automoe_tpu_torch.data import get_bdd_detection_loader, get_carla_detection_loader
    from automoe_tpu_torch.evals.detection import detection_eval_batch
    from automoe_tpu_torch.evals.plots import (
        analyze_detection_per_image,
        draw_detections,
        topk_predictions,
    )
    from automoe_tpu_torch.train.workloads import bdd_expert_workload
    from automoe_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    factory = (get_carla_detection_loader if args.source == "carla"
               else get_bdd_detection_loader)
    kw = {"root_dir": args.data_root} if args.data_root else {}
    loader = factory(split=args.split, batch_size=args.batch_size,
                     num_workers=args.num_workers, shuffle=False,
                     box_cap=args.box_cap, **kw)
    model = _load_model(bdd_expert_workload("detection").build_model, args.checkpoint, dev)

    vis_dir = Path(args.out_dir) / "vis"
    rows = []
    done = 0
    with torch.no_grad():
        for batch in loader:
            image = torch.as_tensor(batch["image"], device=dev)
            out = model(image.permute(0, 3, 1, 2))
            m = detection_eval_batch(out["class_logits"], out["bbox_deltas"],
                                     torch.as_tensor(batch["bboxes"], device=dev),
                                     torch.as_tensor(batch["labels"], device=dev),
                                     num_classes=model.num_classes)
            logits = out["class_logits"].permute(0, 2, 3, 1).cpu().numpy()
            deltas = out["bbox_deltas"].permute(0, 2, 3, 1).cpu().numpy()
            sample_iou = m["sample_iou"].cpu().numpy()
            sample_recall = m["sample_recall"].cpu().numpy()
            H, W = batch["image"].shape[1:3]
            for i in range(len(batch["image"])):
                if done >= args.max_images:
                    break
                pred_xyxy, scores = topk_predictions(
                    logits[i], deltas[i], k=args.topk, threshold=args.threshold,
                    image_hw=(H, W),
                )
                labels = np.asarray(batch["labels"][i])
                gt = np.asarray(batch["bboxes"][i])[labels >= 0]
                draw_detections(np.asarray(batch["image"][i]), gt, pred_xyxy,
                                str(vis_dir / f"det_{done:04d}.jpg"), scores)
                n_gt = int((labels >= 0).sum())
                rows.append({
                    "n_gt": n_gt,
                    "n_match": n_gt,  # every GT is matched under set matching
                    "mean_iou": float(sample_iou[i]),
                    "recall": float(sample_recall[i]),
                })
                done += 1
            if done >= args.max_images:
                break
    table = analyze_detection_per_image(
        rows, str(_timestamped(args.out_dir, "detection_per_image")))
    print(json.dumps(table[: min(5, len(table))]))
    return table


def main(argv=None):
    p = argparse.ArgumentParser("automoe-eval-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--data-root", default=None)
        sp.add_argument("--split", default="val")
        sp.add_argument("--batch-size", type=int, default=32)
        sp.add_argument("--num-workers", type=int, default=4)
        sp.add_argument("--image-size", type=int, default=256,
                        help="the JAX CLI's flag; the port's models take the data's size")
        sp.add_argument("--box-cap", type=int, default=48)
        sp.add_argument("--out-dir", default="eval_out")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' to run without a GPU)")

    pb = sub.add_parser("bdd")
    pb.add_argument("--task", choices=["detection", "segmentation", "drivable"],
                    required=True)
    pb.add_argument("--source", choices=["bdd", "carla"], default="bdd")
    pb.add_argument("--quantize", action="store_true",
                    help="evaluate through the int8 serving trunk "
                         "(PTQ fidelity against the float numbers)")
    common(pb)
    pb.set_defaults(fn=cmd_bdd)

    pn = sub.add_parser("nuscenes")
    common(pn)
    pn.set_defaults(fn=cmd_nuscenes)

    pg = sub.add_parser("gating")
    pg.add_argument("--model-config", default=None)
    pg.add_argument("--use-logits", action="store_true")
    pg.add_argument("--quantize", action="store_true",
                    help="evaluate through the int8 PTQ serving path "
                         "(calibrated on the first val batch)")
    common(pg)
    pg.set_defaults(fn=cmd_gating)

    pt = sub.add_parser("training-curves")
    pt.add_argument("--run-dir", required=True,
                    help="training run dir containing metrics.jsonl")
    pt.add_argument("--out", default=None, help="output PNG path")
    pt.add_argument("--tags", default=None,
                    help="comma-separated scalar tags (default: first 4)")
    pt.set_defaults(fn=cmd_training_curves)

    pv = sub.add_parser("visualize-detection")
    pv.add_argument("--source", choices=["bdd", "carla"], default="bdd")
    pv.add_argument("--max-images", type=int, default=16)
    # reference defaults: top-100 drawn at score >= 0.30
    # (visualize_bdd100k_detection.py:92-93)
    pv.add_argument("--topk", type=int, default=100)
    pv.add_argument("--threshold", type=float, default=0.3)
    common(pv)
    pv.set_defaults(fn=cmd_visualize)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
