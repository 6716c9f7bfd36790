"""Post-training int8 quantization for the serving path (port of
automoe_tpu/serving/quant.py, the path `make_quant_forward` runs by
default: trunk "q8", stem "s2d").

  * BatchNorm is FOLDED into the preceding conv (exact at inference);
  * trunk weights are int8 with per-output-channel scales (symmetric);
  * activations are int8 with per-tensor scales from abs-max calibration;
  * the stems of all experts run as ONE space-to-depth conv whose int8
    output is pooled in the same kernel (ops/stem.py, kernel K3), or, in
    the "pool" variant, as a torch conv + quantize followed by the int8
    pool kernel K4;
  * the int8 trunk convs are im2col (Tensor.unfold views) + torch._int_mm
    (int8 x int8 → int32, exact), with requantization folded into each
    conv's f32 epilogue so activations stay int8 between convs.

Heads, extractors, gating and policy are the model's own modules in the
engine's dtype. Host-side scale constants are computed exactly as the
JAX package computes them, so the requantization matches it bit for bit
wherever the int32 accumulators do.

Layouts: folded weights are OIHW (torch); the int8 trunk runs NHWC.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from automoe_tpu_torch.configs import load_model_config
from automoe_tpu_torch.models.automoe import simple_context
from automoe_tpu_torch.models.resnet import STAGES
from automoe_tpu_torch.ops.stem import (
    maxpool3x3s2_int8,
    quantize_int8,
    s2d_stem_pool_int8,
)

_STAGES = [(s, f, st) for s, (f, st) in enumerate(STAGES, start=1)]

#: convs kept in float: the C=3 7x7 stem, which the s2d stem replaces
DEFAULT_FLOAT_CONVS = frozenset({"conv1"})


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _bn_affine(bn: torch.nn.BatchNorm2d):
    """(g, b) in float64 with bn(x) == g*x + b in eval mode."""
    inv = 1.0 / np.sqrt(_np64(bn.running_var) + bn.eps)
    g = _np64(bn.weight) * inv
    b = _np64(bn.bias) - _np64(bn.running_mean) * g
    return g, b


def fold_resnet(backbone) -> Dict[str, Dict[str, np.ndarray]]:
    """Fold every BatchNorm of a ResNet18Backbone into its preceding conv.

    Returns {conv_name: {"w": [O,I,kh,kw] f32, "b": [O] f32}} with names
    'conv1', 'layer{s}_{b}/conv1|conv2|downsample_conv' (the JAX
    package's names).
    """

    def fold(conv, bn):
        g, b = _bn_affine(bn)
        w = _np64(conv.weight) * g[:, None, None, None]
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    out = {"conv1": fold(backbone[0], backbone[1])}
    for stage, _, _ in _STAGES:
        for blk in (0, 1):
            m = backbone[3 + stage][blk]
            n = f"layer{stage}_{blk}"
            out[f"{n}/conv1"] = fold(m.conv1, m.bn1)
            out[f"{n}/conv2"] = fold(m.conv2, m.bn2)
            if m.downsample is not None:
                out[f"{n}/downsample_conv"] = fold(m.downsample[0], m.downsample[1])
    return out


def quantize_folded(folded: Dict, float_convs: frozenset = DEFAULT_FLOAT_CONVS
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """int8 symmetric per-output-channel weights from a folded tree;
    convs named in `float_convs` keep their folded float weights."""
    q = {}
    for name, p in folded.items():
        if name in float_convs:
            q[name] = {"w": p["w"], "b": p["b"]}
            continue
        w = p["w"]
        amax = np.maximum(np.abs(w).max(axis=(1, 2, 3)), 1e-12)  # [O]
        sw = (amax / 127.0).astype(np.float32)
        wq = np.clip(np.round(w / sw[:, None, None, None]), -127, 127).astype(np.int8)
        q[name] = {"wq": wq, "sw": sw, "b": p["b"]}
    return q


def _resnet_graph(conv, x: torch.Tensor) -> torch.Tensor:
    """ResNet-18 trunk over an abstract conv(name, x, stride, pad) (bias
    included), NCHW."""
    x = torch.relu(conv("conv1", x, 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, filters, stride in _STAGES:
        for blk in (0, 1):
            n = f"layer{stage}_{blk}"
            s = stride if blk == 0 else 1
            y = torch.relu(conv(f"{n}/conv1", x, s, 1))
            y = conv(f"{n}/conv2", y, 1, 1)
            if x.shape[1] != filters or s != 1:
                r = conv(f"{n}/downsample_conv", x, s, 0)
            else:
                r = x
            x = torch.relu(y + r)
    return x


def resnet_float_forward(folded: Dict, x: torch.Tensor, dtype=torch.float32,
                         collect: Optional[Dict] = None) -> torch.Tensor:
    """BN-folded float trunk over NCHW x (== the backbone in eval mode).
    With `collect`, records each conv input's abs-max (0-d f32 tensors)."""

    def conv(name, x, stride, pad):
        if collect is not None:
            collect[name] = x.float().abs().max()
        w = torch.as_tensor(folded[name]["w"], device=x.device).to(dtype)
        b = torch.as_tensor(folded[name]["b"], device=x.device).to(dtype)
        return F.conv2d(x.to(dtype), w, stride=stride, padding=pad) + b[:, None, None]

    return _resnet_graph(conv, x.to(dtype))


# ---------------------------------------------------------------------------
# Device packs
# ---------------------------------------------------------------------------

def _act_scale(s: float) -> np.float32:
    return np.float32(float(max(s, 1e-12)) / 127.0)


def pack_trunk(qpack: Dict, scales: Dict[str, float], device) -> Dict[str, Dict]:
    """int8 convs of one quantized trunk as device tensors for the
    im2col matmul: wmat [kh*kw*I, O] int8 (rows ordered kh, kw, cin),
    dequant vectors sw·s_in f32 (formed in numpy f32, as the JAX package
    forms them) and bias f32."""
    out = {}
    for name, p in qpack.items():
        if "wq" not in p:
            continue
        wq = p["wq"]
        O, I, kh, kw = wq.shape
        s_in = _act_scale(scales[name])
        if name.endswith("downsample_conv"):
            # the downsample shares conv1's int8 input, so it dequantizes
            # with conv1's scale (its own calibrated scale is ~equal)
            s_in = _act_scale(scales[name.replace("downsample_conv", "conv1")])
        out[name] = {
            "wmat": torch.from_numpy(
                np.ascontiguousarray(wq.transpose(2, 3, 1, 0).reshape(kh * kw * I, O))
            ).to(device),
            "scale": torch.from_numpy(p["sw"] * s_in).to(device),
            "b": torch.from_numpy(p["b"]).to(device),
            "k": kh,
        }
    return out


def _conv_i8(xq: torch.Tensor, p: Dict, stride: int, pad: int) -> torch.Tensor:
    """int8 NHWC conv → int32 NHWC accumulators (exact)."""
    k = p["k"]
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    B, H, W, C = xq.shape
    if k == 1:
        cols = xq[:, ::stride, ::stride]
    else:
        # [B,OH,OW,C,kh,kw] views → rows ordered (kh, kw, cin)
        cols = xq.unfold(1, k, stride).unfold(2, k, stride).permute(0, 1, 2, 4, 5, 3)
    oh, ow = cols.shape[1], cols.shape[2]
    m = B * oh * ow
    a = cols.reshape(m, -1)
    if a.is_cuda and m <= 16:  # the CUDA int8 GEMM takes more than 16 rows only
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), p["wmat"])[:m].reshape(B, oh, ow, -1)


def resnet_quant_forward_q8(trunk: Dict, scales: Dict[str, float],
                            stem_in, dtype=torch.bfloat16) -> torch.Tensor:
    """int8-RESIDENT trunk from the int8 stem output `stem_in` =
    (xq [B,h,w,64] int8 NHWC, si): requantization is folded into each
    conv's dequant epilogue, and the identity residual is dequantized
    from the block's int8 input. Returns NHWC features in `dtype`."""

    def sx(name: str) -> np.float32:
        return _act_scale(scales[name])

    def quant(v_f32, s):
        return quantize_int8(v_f32, float(np.float32(1.0 / s)))

    def deq(y_i32, p):
        return y_i32.float() * p["scale"] + p["b"]

    xq, si = stem_in
    for stage, _, stride in _STAGES:
        for blk in (0, 1):
            n = f"layer{stage}_{blk}"
            s = stride if blk == 0 else 1
            p1, p2 = trunk[f"{n}/conv1"], trunk[f"{n}/conv2"]
            s2 = sx(f"{n}/conv2")
            hq = quant(torch.relu(deq(_conv_i8(xq, p1, s, 1), p1)), s2)
            a2 = deq(_conv_i8(hq, p2, 1, 1), p2)
            if f"{n}/downsample_conv" in trunk:
                pd = trunk[f"{n}/downsample_conv"]
                r = deq(_conv_i8(xq, pd, s, 0), pd)
            else:
                r = xq.float() * float(si)
            out = torch.relu(a2 + r)
            if stage == 4 and blk == 1:  # last block → heads want dtype
                return out.to(dtype)
            si = sx(f"layer{stage}_1/conv1" if blk == 0 else f"layer{stage + 1}_0/conv1")
            xq = quant(out, si)
    raise AssertionError("unreachable")


def _s2d_stem_kernel(w: np.ndarray) -> np.ndarray:
    """Rewrite a [O,C,7,7] stride-2 pad-3 stem kernel into the exactly
    equivalent [4,4,4C,O] (HWIO) stride-1 VALID kernel over a 2x2
    space-to-depth input padded (4,4): zero-pad 7->8 (shift by one so
    pad-3 becomes pad-4), then block-reshape so channel = di*2C + dj*C + c
    matches the s2d layout of `_space_to_depth`."""
    O, C = w.shape[0], w.shape[1]
    w8 = np.zeros((8, 8, C, O), w.dtype)
    w8[1:8, 1:8] = w.transpose(2, 3, 1, 0)
    k = w8.reshape(4, 2, 4, 2, C, O).transpose(0, 2, 1, 3, 4, 5)
    return k.reshape(4, 4, 4 * C, O)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B,C,H,W] → pad (4,4) → NHWC [B,(H+8)/2,(W+8)/2,4C] with
    channel di*2C + dj*C + c."""
    B, C, H, W = x.shape
    xp = F.pad(x, (4, 4, 4, 4))
    xs = xp.reshape(B, C, (H + 8) // 2, 2, (W + 8) // 2, 2)
    return xs.permute(0, 2, 4, 3, 5, 1).reshape(B, (H + 8) // 2, (W + 8) // 2, 4 * C)


class S2DStem:
    """All E float stems as ONE space-to-depth conv with int8 output,
    pooled. Built once from the quantized packs; called per step.

    variant "fused" → kernel K3 (conv + bias + ReLU + quantize + pool in
    one pass, f32 accumulation); "pool" → conv + bias + ReLU in `dtype` as
    torch ops, quantize, then kernel K4. On CPU tensors both run the
    kernels' plain versions."""

    def __init__(self, qpacks: Sequence[Dict], scales: Sequence[Dict[str, float]],
                 dtype=torch.bfloat16, device="cpu"):
        ks, bs, sis = [], [], []
        for q, s in zip(qpacks, scales):
            p = q["conv1"]
            if "wq" in p:
                raise NotImplementedError("s2d stem expects float stems")
            # weights and bias pass through `dtype` first, as in the JAX
            # package (the rewrite itself is pure data movement)
            w = torch.from_numpy(p["w"]).to(dtype).float().numpy()
            ks.append(_s2d_stem_kernel(w))
            bs.append(p["b"])
            sis.append(_act_scale(s["layer1_0/conv1"]))
        self.dtype = dtype
        self.channels = ks[0].shape[-1]
        self.sis = sis
        k = np.concatenate(ks, axis=-1)  # [4,4,12,64E]
        O = k.shape[-1]
        self.wmat = torch.from_numpy(k.reshape(16 * k.shape[2], O)).to(device, dtype)
        self.w_oihw = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))
                                       ).to(device, dtype)
        bias = torch.from_numpy(np.concatenate(bs)).to(dtype)
        self.bias_dt = bias.to(device)
        self.bias_f32 = bias.float().to(device)
        inv = np.repeat(np.asarray([1.0 / s for s in sis], np.float32), self.channels)
        self.inv = torch.from_numpy(inv).to(device)

    def __call__(self, x: torch.Tensor, variant: str = "fused"):
        """x NCHW image → [(xq int8 [B,H/4,W/4,64] NHWC, si), ...] per expert."""
        xs = _space_to_depth(x.to(self.dtype))
        _, H, W = x.shape[1:]
        if variant == "fused":
            hq = s2d_stem_pool_int8(xs, self.wmat, self.bias_f32, self.inv)
        elif variant == "pool":
            h = F.conv2d(xs.permute(0, 3, 1, 2), self.w_oihw)[:, :, : H // 2, : W // 2]
            h = torch.relu(h + self.bias_dt[:, None, None])
            hq = quantize_int8(h, self.inv[:, None, None])
            hq = maxpool3x3s2_int8(hq.permute(0, 2, 3, 1).contiguous())
        else:
            raise ValueError(f"unknown stem variant {variant!r}")
        C = self.channels
        return [(hq[..., i * C:(i + 1) * C], self.sis[i]) for i in range(len(self.sis))]


def stems_s2d_q8(qpacks: Sequence[Dict], scales: Sequence[Dict[str, float]],
                 x: torch.Tensor, dtype=torch.bfloat16, variant: str = "fused"):
    """Functional form of `S2DStem` (builds the stem constants per call)."""
    return S2DStem(qpacks, scales, dtype, x.device)(x, variant)


# ---------------------------------------------------------------------------
# AutoMoE-level assembly
# ---------------------------------------------------------------------------

def _backbone(expert):
    return expert.image_backbone if hasattr(expert, "image_backbone") else expert.backbone


def fold_experts(model) -> List[Dict]:
    return [fold_resnet(_backbone(e)) for e in model.experts]


@torch.no_grad()
def calibrate_automoe(model, batches: Sequence[Dict], dtype=torch.bfloat16,
                      folded: Optional[List[Dict]] = None) -> List[Dict[str, float]]:
    """Per-expert per-conv activation abs-max over calibration batches
    (AutoMoE input dicts; only the NHWC 'image', already preprocessed, is
    consumed)."""
    if folded is None:
        folded = fold_experts(model)
    acc: List[Dict[str, float]] = [dict() for _ in folded]
    for batch in batches:
        image = torch.as_tensor(batch["image"]).to(dtype).permute(0, 3, 1, 2)
        for i, f in enumerate(folded):
            c: Dict[str, torch.Tensor] = {}
            resnet_float_forward(f, image, dtype=dtype, collect=c)
            for k, v in c.items():
                acc[i][k] = max(acc[i].get(k, 0.0), float(v))
    return acc


def quantize_automoe(model, calib_batches: Sequence[Dict], dtype=torch.bfloat16,
                     float_convs: frozenset = DEFAULT_FLOAT_CONVS) -> Dict[str, Any]:
    """The int8 serving pack: folded+quantized trunk weights (numpy) and
    calibrated activation scales per expert. Fold from the model's float32
    weights, before it is cast to a lower serving dtype."""
    folded = fold_experts(model)
    scales = calibrate_automoe(model, calib_batches, dtype=dtype, folded=folded)
    return {"experts": [quantize_folded(f, float_convs) for f in folded],
            "scales": scales}


def prepare_qexperts(qpack: Dict[str, Any], dtype=torch.bfloat16, device="cpu") -> Dict:
    """Device-side constants of a `quantize_automoe` pack: the s2d stem
    and each expert's int8 trunk."""
    return {
        "stem": S2DStem(qpack["experts"], qpack["scales"], dtype, device),
        "trunks": [pack_trunk(q, s, device)
                   for q, s in zip(qpack["experts"], qpack["scales"])],
    }


def make_quant_forward(config, scales: List[Dict[str, float]], dtype=torch.bfloat16,
                       stem_variant: str = "fused"):
    """fn(model, qexperts, batch) -> AutoMoE serving outputs with int8
    expert trunks; heads, extractors, gating and policy are `model`'s own
    modules (cast to `dtype`), with the fast gating pool. `qexperts`
    comes from `prepare_qexperts`. The lidar branch is not ported."""
    config = load_model_config(config)
    for ecfg in config.experts:
        if ecfg.type == "nuscenes" and ecfg.use_lidar:
            raise NotImplementedError("the lidar branch is not ported yet")

    @torch.no_grad()
    def forward(model, qexperts: Dict, batch: Dict[str, torch.Tensor]):
        if not model.fast_gating_pool:
            raise ValueError("the int8 forward pools seg/drivable logits "
                             "at low res: build the model with fast_gating_pool")
        image = batch["image"].to(dtype).permute(0, 3, 1, 2)  # NHWC → NCHW
        B = image.shape[0]
        context_features = model.context_extractor(
            *simple_context(batch, B, dtype, image.device)
        )
        stems = qexperts["stem"](image, stem_variant)
        expert_outputs = []
        for i, (ecfg, expert) in enumerate(zip(config.experts, model.experts)):
            feats = resnet_quant_forward_q8(
                qexperts["trunks"][i], scales[i], stems[i], dtype=dtype
            ).permute(0, 3, 1, 2)  # [B,512,h,w]
            if ecfg.type == "nuscenes":
                expert_outputs.append(expert.heads(feats.mean(dim=(2, 3))))
            else:
                expert_outputs.append(expert.heads(feats))
        features = model.extractor_features(expert_outputs, image.shape[2:])
        out = model.head_outputs(image, features, context_features)
        return {k: out[k] for k in ("waypoints", "speed", "speed_seq",
                                    "expert_weights", "combined_features",
                                    "gate_logits")}

    return forward
