"""Plot and visualization artifacts (matplotlib with the Agg backend, PIL):
the port's own copy of automoe_tpu/evals/plots.py, which imports only
numpy, matplotlib and PIL. Parity with the reference eval tooling:

  * expert usage bar + pie charts (eval/evaluate_gating_network.py:106-132)
  * correlation heatmaps (:239-254)
  * detection GT-vs-prediction overlays, GT green / predictions red
    (eval/visualize_bdd100k_detection.py:15-81)

matplotlib is optional, as in the JAX package (its `dev` extra): where it
is not installed, the three charts are drawn with PIL instead (the same
panels, plainer), at the same paths, and a note says so on stderr.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _pil_save(img, save_path: str) -> None:
    print(f"matplotlib is not installed: {save_path} drawn with PIL", file=sys.stderr)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    img.save(save_path)


_PALETTE = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
            (140, 86, 75), (227, 119, 194), (127, 127, 127)]


def _pil_axes(draw, box, xs, ys, title: str) -> None:
    """A framed panel in `box` (x0, y0, x1, y1) with the polyline (xs, ys)
    scaled into it and `title` above."""
    x0, y0, x1, y1 = box
    draw.rectangle(box, outline=(0, 0, 0))
    draw.text((x0, y0 - 14), title, fill=(0, 0, 0))
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    sx = (x1 - x0) / max(float(np.ptp(xs)), 1e-12)
    sy = (y1 - y0) / max(float(np.ptp(ys)), 1e-12)
    pts = [(x0 + (x - xs.min()) * sx, y1 - (y - ys.min()) * sy) for x, y in zip(xs, ys)]
    if len(pts) > 1:
        draw.line(pts, fill=_PALETTE[0], width=2)
    draw.text((x0 + 2, y0 + 2), f"{ys.max():.4g}", fill=(0, 0, 0))
    draw.text((x0 + 2, y1 - 12), f"{ys.min():.4g}", fill=(0, 0, 0))


def _pil_expert_usage(usage, std, names, save_path: str) -> None:
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (1200, 500), "white")
    draw = ImageDraw.Draw(img)
    draw.text((40, 10), "Expert usage (mean ± std)", fill=(0, 0, 0))
    top = max(float((usage + std).max()), 1e-12)
    width = 480 // max(len(usage), 1)
    for i, (u, s, name) in enumerate(zip(usage, std, names)):
        x = 60 + i * width
        draw.rectangle((x, 450 - 400 * u / top, x + width * 0.7, 450), fill=_PALETTE[0])
        xm = x + width * 0.35
        draw.line((xm, 450 - 400 * (u - s) / top, xm, 450 - 400 * (u + s) / top),
                  fill=(0, 0, 0), width=2)
        draw.text((x, 455), str(name), fill=(0, 0, 0))
    draw.text((640, 10), "Expert usage share", fill=(0, 0, 0))
    start, total = 0.0, max(float(usage.sum()), 1e-12)
    for i, (u, name) in enumerate(zip(usage, names)):
        end = start + 360.0 * u / total
        draw.pieslice((700, 60, 1100, 460), start, end, fill=_PALETTE[i % len(_PALETTE)])
        mid = np.deg2rad((start + end) / 2)
        draw.text((900 + 120 * np.cos(mid), 260 + 120 * np.sin(mid)),
                  f"{name} {100 * u / total:.1f}%", fill=(0, 0, 0))
        start = end
    _pil_save(img, save_path)


def _pil_training_curves(series, chosen, save_path: str) -> None:
    from PIL import Image, ImageDraw

    rows = (len(chosen) + 1) // 2
    img = Image.new("RGB", (1200, 400 * rows), "white")
    draw = ImageDraw.Draw(img)
    for k, tag in enumerate(chosen):
        x0, y0 = 60 + 600 * (k % 2), 40 + 400 * (k // 2)
        pts = series[tag]
        _pil_axes(draw, (x0, y0, x0 + 500, y0 + 320), [p[0] for p in pts],
                  [p[1] for p in pts], tag)
    _pil_save(img, save_path)


def _pil_heatmap(matrix, context_names, expert_names, title: str, save_path: str) -> None:
    from PIL import Image, ImageDraw

    m = np.asarray(matrix, np.float64)
    cw, ch, left, top = 90, 50, 120, 40
    img = Image.new("RGB", (left + cw * m.shape[1] + 20, top + ch * m.shape[0] + 80), "white")
    draw = ImageDraw.Draw(img)
    draw.text((left, 10), title, fill=(0, 0, 0))
    blue, white, red = np.array([5, 48, 97]), np.array([247, 247, 247]), np.array([103, 0, 31])
    for i in range(m.shape[0]):
        draw.text((5, top + ch * i + ch // 2 - 6), str(context_names[i]), fill=(0, 0, 0))
        for j in range(m.shape[1]):
            t = float(np.clip(m[i, j] / 0.8, -1.0, 1.0))  # RdBu_r over [-0.8, 0.8]
            rgb = white + (red - white) * t if t >= 0 else white + (blue - white) * -t
            box = (left + cw * j, top + ch * i, left + cw * (j + 1), top + ch * (i + 1))
            draw.rectangle(box, fill=tuple(int(c) for c in rgb))
            draw.text((box[0] + 5, box[1] + 5), f"{m[i, j]:.2f}",
                      fill=(0, 0, 0) if abs(t) < 0.6 else (255, 255, 255))
    for j, name in enumerate(expert_names):
        draw.text((left + cw * j + 5, top + ch * m.shape[0] + 8), str(name), fill=(0, 0, 0))
    _pil_save(img, save_path)


def plot_expert_usage(
    expert_usage: Sequence[float],
    expert_std: Sequence[float],
    expert_names: Sequence[str],
    save_path: str,
) -> None:
    usage = np.asarray(expert_usage)
    std = np.asarray(expert_std)
    plt = _pyplot()
    if plt is None:
        return _pil_expert_usage(usage, std, expert_names, save_path)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax1.bar(expert_names, usage, yerr=std, capsize=4)
    ax1.set_ylabel("Mean gating weight")
    ax1.set_title("Expert usage (mean ± std)")
    ax1.tick_params(axis="x", rotation=30)
    ax2.pie(usage, labels=expert_names, autopct="%1.1f%%")
    ax2.set_title("Expert usage share")
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)


def plot_training_curves(
    metrics_jsonl: str,
    save_path: str,
    tags: Optional[Sequence[str]] = None,
    max_panels: int = 4,
) -> List[str]:
    """Panel grid of training curves from a run's metrics.jsonl (parity
    with the reference's TensorBoard-scraping plot_training_curves,
    eval/evaluate_gating_network.py:135-167 — our runs log JSONL + TB, and
    JSONL is the durable source). Plots the first `max_panels` scalar tags
    (or the given `tags`) against step. Returns the tags plotted."""
    import json

    series: dict = {}
    for line in Path(metrics_jsonl).read_text().splitlines():
        rec = json.loads(line)
        step = rec.get("step", 0)
        for k, v in rec.items():
            if k in ("step", "time") or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, []).append((step, v))
    chosen = list(tags) if tags else list(series)[:max_panels]
    chosen = [t for t in chosen if t in series][:max_panels]
    if not chosen:
        raise ValueError(f"no scalar series found in {metrics_jsonl}")
    plt = _pyplot()
    if plt is None:
        _pil_training_curves(series, chosen, save_path)
        return chosen

    rows = (len(chosen) + 1) // 2
    fig, axes = plt.subplots(rows, 2, figsize=(12, 4 * rows), squeeze=False)
    flat = axes.flatten()
    for ax in flat[len(chosen):]:
        ax.axis("off")
    for ax, tag in zip(flat, chosen):
        pts = series[tag]
        ax.plot([p[0] for p in pts], [p[1] for p in pts])
        ax.set_title(tag)
        ax.set_xlabel("Step")
        ax.set_ylabel("Value")
        ax.grid(True)
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return chosen


def plot_correlation_heatmap(
    matrix: np.ndarray,
    context_names: Sequence[str],
    expert_names: Sequence[str],
    title: str,
    save_path: str,
) -> None:
    plt = _pyplot()
    if plt is None:
        return _pil_heatmap(matrix, context_names, expert_names, title, save_path)
    fig, ax = plt.subplots(
        figsize=(1.6 * len(expert_names) + 3, 1.1 * len(context_names) + 2)
    )
    im = ax.imshow(matrix, cmap="RdBu_r", vmin=-0.8, vmax=0.8, aspect="auto")
    ax.set_yticks(range(len(context_names)), context_names)
    ax.set_xticks(range(len(expert_names)), expert_names, rotation=45, ha="right")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def draw_detections(
    image_01: np.ndarray,
    gt_boxes_xyxy: Optional[np.ndarray],
    pred_boxes_xyxy: Optional[np.ndarray],
    save_path: str,
    pred_scores: Optional[np.ndarray] = None,
) -> None:
    """image [H,W,3] in [0,1]; GT drawn green, predictions red."""
    from PIL import Image, ImageDraw

    img = Image.fromarray((np.clip(image_01, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    H, W = image_01.shape[:2]

    def _draw(boxes, color, scores=None):
        if boxes is None:
            return
        for i, b in enumerate(np.asarray(boxes).reshape(-1, 4)):
            if (b < 0).all():
                continue
            x1, y1, x2, y2 = [float(v) for v in b]
            # raw predictions may have inverted corners (negative w/h)
            x1, x2 = sorted((x1, x2))
            y1, y2 = sorted((y1, y2))
            box = [max(0, x1), max(0, y1), min(W - 1, x2), min(H - 1, y2)]
            if box[2] <= box[0] or box[3] <= box[1]:
                continue
            draw.rectangle(box, outline=color, width=2)
            if scores is not None:
                draw.text((x1 + 2, y1 + 2), f"{scores[i]:.2f}", fill=color)

    _draw(gt_boxes_xyxy, (0, 255, 0))
    _draw(pred_boxes_xyxy, (255, 0, 0), pred_scores)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    img.save(save_path)


def topk_predictions(
    class_logits: np.ndarray,
    bbox_deltas: np.ndarray,
    *,
    k: int = 10,
    threshold: float = 0.3,
    image_hw: tuple = (256, 256),
):
    """Dense-grid cells → top-k thresholded cxcywh→xyxy pixel boxes
    (semantics of eval/visualize_bdd100k_detection.py:15-81: scores are
    max softmax prob per cell)."""
    h, w, C = class_logits.shape
    probs = np.exp(class_logits - class_logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    scores = probs.max(-1).reshape(-1)
    boxes = bbox_deltas.reshape(-1, 4)
    order = np.argsort(-scores)[:k]
    keep = order[scores[order] >= threshold]
    cx, cy, bw, bh = boxes[keep].T
    H, W = image_hw
    xyxy = np.stack(
        [(cx - bw / 2) * W, (cy - bh / 2) * H, (cx + bw / 2) * W, (cy + bh / 2) * H],
        axis=-1,
    )
    return xyxy, scores[keep]


def analyze_detection_per_image(
    sample_metrics: List[dict], save_path: Optional[str] = None
) -> List[dict]:
    """Per-image nGT/nMatch/meanIoU/recall table (parity with
    eval/analyze_bdd100k_detection_batch.py:15-89). Input: list of dicts
    with keys n_gt, n_match, mean_iou, recall; writes JSON when asked."""
    import json

    rows = [
        {
            "index": i,
            "n_gt": int(m["n_gt"]),
            "n_match": int(m["n_match"]),
            "mean_iou": float(m["mean_iou"]),
            "recall_0.5": float(m["recall"]),
        }
        for i, m in enumerate(sample_metrics)
    ]
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        Path(save_path).write_text(json.dumps(rows, indent=2))
    return rows
