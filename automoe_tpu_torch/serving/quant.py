"""Post-training int8 quantization for the serving path (port of
automoe_tpu/serving/quant.py): `make_quant_forward` with the JAX
package's trunks ("q8", int8-resident, the default; "v1", a round trip
through the serving dtype between convs) and q8 stems ("s2d", the
default; "fused", one dense 7x7 conv over all experts; "solo", each
expert's own float stem); and, for one expert evaluated alone,
`quantize_expert` + `make_expert_quant_apply` over either trunk with the
expert's own float stem.

  * BatchNorm is FOLDED into the preceding conv (exact at inference);
  * trunk weights are int8 with per-output-channel scales (symmetric);
  * activations are int8 with per-tensor scales from abs-max calibration;
  * the "s2d" stem runs the stems of all experts as ONE space-to-depth
    conv whose int8 output is pooled in the same kernel (ops/stem.py,
    kernel K3), or, in the "pool" variant, as a torch conv + quantize
    followed by the int8 pool kernel K4; the "fused" and "solo" stems and
    the v1 trunk's stem are torch convs (XLA convs in the JAX package,
    no Pallas kernel);
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
from automoe_tpu_torch.models.automoe import lidar_or_zeros
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


def pack_trunk(qpack: Dict, scales: Dict[str, float], device, trunk: str = "q8"
               ) -> Dict[str, Dict]:
    """int8 convs of one quantized trunk as device tensors for the
    im2col matmul: wmat [kh*kw*I, O] int8 (rows ordered kh, kw, cin),
    dequant vectors sw·s_in f32 (formed in numpy f32, as the JAX package
    forms them) and bias f32. For trunk "v1" each conv quantizes its own
    input: the downsample dequantizes with its own scale, and each conv
    carries the multiplier `inv` of its input's quantize."""
    out = {}
    for name, p in qpack.items():
        if "wq" not in p:
            continue
        wq = p["wq"]
        O, I, kh, kw = wq.shape
        s_in = _act_scale(scales[name])
        if trunk != "v1" and name.endswith("downsample_conv"):
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
        if trunk == "v1":
            # the JAX v1 trunk takes 1/s from the float64 scale
            out[name]["inv"] = float(np.float32(1.0 / (float(max(scales[name], 1e-12))
                                                       / 127.0)))
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


def _quant(v_f32: torch.Tensor, s) -> torch.Tensor:
    return quantize_int8(v_f32, float(np.float32(1.0 / s)))


def q8_block(trunk: Dict, scales: Dict[str, float], name: str, xq: torch.Tensor, si,
             stride: int) -> torch.Tensor:
    """One BasicBlock `name` ('layer{s}_{b}') of the int8 trunk on its int8
    input (xq NHWC, scale si): the block's f32 output, before it is
    requantized for the next block."""

    def deq(y_i32, p):
        return y_i32.float() * p["scale"] + p["b"]

    p1, p2 = trunk[f"{name}/conv1"], trunk[f"{name}/conv2"]
    hq = _quant(torch.relu(deq(_conv_i8(xq, p1, stride, 1), p1)),
                _act_scale(scales[f"{name}/conv2"]))
    a2 = deq(_conv_i8(hq, p2, 1, 1), p2)
    if f"{name}/downsample_conv" in trunk:
        pd = trunk[f"{name}/downsample_conv"]
        r = deq(_conv_i8(xq, pd, stride, 0), pd)
    else:
        r = xq.float() * float(si)
    return torch.relu(a2 + r)


def resnet_quant_forward_q8(trunk: Dict, scales: Dict[str, float],
                            stem_in, dtype=torch.bfloat16) -> torch.Tensor:
    """int8-RESIDENT trunk from the int8 stem output `stem_in` =
    (xq [B,h,w,64] int8 NHWC, si): requantization is folded into each
    conv's dequant epilogue, and the identity residual is dequantized
    from the block's int8 input. Returns NHWC features in `dtype`."""
    xq, si = stem_in
    for stage, _, stride in _STAGES:
        for blk in (0, 1):
            out = q8_block(trunk, scales, f"layer{stage}_{blk}", xq, si,
                           stride if blk == 0 else 1)
            if stage == 4 and blk == 1:  # last block → heads want dtype
                return out.to(dtype)
            si = _act_scale(scales[f"layer{stage}_1/conv1" if blk == 0
                                   else f"layer{stage + 1}_0/conv1"])
            xq = _quant(out, si)
    raise AssertionError("unreachable")


def resnet_quant_forward(qexpert: Dict, x: torch.Tensor, dtype=torch.bfloat16
                         ) -> torch.Tensor:
    """The v1 int8 trunk over NCHW x, from `prepare_qexpert(...,
    trunk="v1")`: the float stem (conv + bias in `dtype`, ReLU, 3x3/s2
    max-pool), then every conv quantizes its `dtype` input with its own
    calibrated scale, accumulates in int32 and writes `dtype` (bias in
    f32, then rounded); ReLUs and residual adds run in `dtype`. Returns
    NHWC features in `dtype`."""
    trunk = qexpert["trunk"]

    def conv(name, x, stride, pad):
        p = trunk[name]
        y = _conv_i8(quantize_int8(x, p["inv"]), p, stride, pad)
        return (y.float() * p["scale"] + p["b"]).to(dtype)

    x = float_stem(qexpert, x, dtype).permute(0, 2, 3, 1)  # NHWC
    for stage, _, stride in _STAGES:
        for blk in (0, 1):
            n = f"layer{stage}_{blk}"
            s = stride if blk == 0 else 1
            y = conv(f"{n}/conv2", torch.relu(conv(f"{n}/conv1", x, s, 1)), 1, 1)
            r = conv(f"{n}/downsample_conv", x, s, 0) if f"{n}/downsample_conv" in trunk else x
            x = torch.relu(y + r)
    return x


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


def s2d_stem_pool_unfused(xs: torch.Tensor, w_oihw: torch.Tensor, bias: torch.Tensor,
                          inv: torch.Tensor) -> torch.Tensor:
    """K3's function unfused (the "pool" stem variant): xs [B,Hc+4,Wc+4,12]
    → conv + bias + ReLU in xs's dtype as torch ops, crop to [:Hc,:Wc],
    quantize, then kernel K4 → [B,ceil(Hc/2),ceil(Wc/2),O] int8."""
    hc, wc = xs.shape[1] - 4, xs.shape[2] - 4
    h = F.conv2d(xs.permute(0, 3, 1, 2), w_oihw)[:, :, :hc, :wc]
    h = torch.relu(h + bias[:, None, None])
    hq = quantize_int8(h, inv[:, None, None])
    return maxpool3x3s2_int8(hq.permute(0, 2, 3, 1).contiguous())


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
        if variant == "fused":
            hq = s2d_stem_pool_int8(xs, self.wmat, self.bias_f32, self.inv)
        elif variant == "pool":
            hq = s2d_stem_pool_unfused(xs, self.w_oihw, self.bias_dt, self.inv)
        else:
            raise ValueError(f"unknown stem variant {variant!r}")
        C = self.channels
        return [(hq[..., i * C:(i + 1) * C], self.sis[i]) for i in range(len(self.sis))]


def stems_s2d_q8(qpacks: Sequence[Dict], scales: Sequence[Dict[str, float]],
                 x: torch.Tensor, dtype=torch.bfloat16, variant: str = "fused"):
    """Functional form of `S2DStem` (builds the stem constants per call)."""
    return S2DStem(qpacks, scales, dtype, x.device)(x, variant)


def _float_stems(qpacks: Sequence[Dict]):
    for q in qpacks:
        if "wq" in q["conv1"]:
            raise NotImplementedError("the q8 stems expect float stems")
        yield q["conv1"]


class FusedStem:
    """All E float stems as ONE dense 7x7/s2 conv over the image (their
    kernels concatenated along the output channels: exact), one ReLU and
    max-pool, and one per-channel quantize into each expert's int8 trunk
    entry (the JAX package's fused_stems_q8, an XLA conv there; torch ops
    here)."""

    def __init__(self, qpacks: Sequence[Dict], scales: Sequence[Dict[str, float]],
                 dtype=torch.bfloat16, device="cpu"):
        stems = list(_float_stems(qpacks))
        self.dtype = dtype
        self.sis = [_act_scale(s["layer1_0/conv1"]) for s in scales]
        self.channels = stems[0]["w"].shape[0]
        self.w = torch.from_numpy(np.concatenate([p["w"] for p in stems])).to(device, dtype)
        self.b = torch.from_numpy(np.concatenate([p["b"] for p in stems])).to(device, dtype)
        inv = np.repeat(np.asarray([1.0 / s for s in self.sis], np.float32), self.channels)
        self.inv = torch.from_numpy(inv).to(device)

    def __call__(self, x: torch.Tensor, variant: str = "fused"):
        """x NCHW image → [(xq int8 [B,H/4,W/4,64] NHWC, si), ...] per
        expert (`variant` is the s2d stem's and unused here)."""
        h = F.conv2d(x.to(self.dtype), self.w, stride=2, padding=3) + self.b[:, None, None]
        h = F.max_pool2d(torch.relu(h), 3, 2, 1)
        hq = quantize_int8(h, self.inv[:, None, None]).permute(0, 2, 3, 1).contiguous()
        C = self.channels
        return [(hq[..., i * C:(i + 1) * C], self.sis[i]) for i in range(len(self.sis))]


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


_STEMS = {"s2d": S2DStem, "fused": FusedStem}


def _check_trunk_stem(trunk: str, stem: str) -> None:
    if trunk not in ("q8", "v1"):
        raise ValueError(f"unknown trunk {trunk!r}")
    if stem not in ("s2d", "fused", "solo"):
        raise ValueError(f"unknown stem {stem!r}")


def prepare_qexperts(qpack: Dict[str, Any], dtype=torch.bfloat16, device="cpu", *,
                     trunk: str = "q8", stem: str = "s2d") -> Dict:
    """Device-side constants of a `quantize_automoe` pack for
    `make_quant_forward` with the same trunk and stem: the stem of all
    experts ("s2d", "fused") and each expert's int8 trunk, or each
    expert's own float stem and trunk (`prepare_qexpert`: "solo", and the
    v1 trunk, which has no shared stem)."""
    _check_trunk_stem(trunk, stem)
    experts, scales = qpack["experts"], qpack["scales"]
    out = {"trunk": trunk, "stem_kind": stem}
    if trunk == "v1" or stem == "solo":
        out["experts"] = [prepare_qexpert(q, s, dtype, device, trunk=trunk)
                          for q, s in zip(experts, scales)]
    else:
        out["stem"] = _STEMS[stem](experts, scales, dtype, device)
        out["trunks"] = [pack_trunk(q, s, device) for q, s in zip(experts, scales)]
    return out


def make_quant_forward(config, scales: List[Dict[str, float]], dtype=torch.bfloat16,
                       stem_variant: str = "fused", *, trunk: str = "q8", stem: str = "s2d"):
    """fn(model, qexperts, batch) -> AutoMoE serving outputs with int8
    expert trunks; heads, extractors, context, gating and policy are
    `model`'s own modules (cast to `dtype`), with the fast gating pool and
    noise-free routing. `qexperts` comes from `prepare_qexperts` with the
    same `trunk` and `stem`. A LiDAR nuScenes expert runs its PointNet in
    `dtype` beside the int8 image trunk, on the batch's points or, without
    them, on zero points as the float model does.

    trunk and stem have the JAX package's meanings: trunk "q8" or "v1"
    (which ignores `stem`, as in JAX); stem "s2d", "fused" or "solo".
    `stem_variant` is this port's own choice of how the "s2d" stem runs:
    "fused" is kernel K3 (JAX's s2d stem with use_pallas=True), "pool" a
    torch conv + quantize followed by kernel K4."""
    _check_trunk_stem(trunk, stem)
    config = load_model_config(config)

    @torch.no_grad()
    def forward(model, qexperts: Dict, batch: Dict[str, torch.Tensor]):
        if not model.fast_gating_pool:
            raise ValueError("the int8 forward pools seg/drivable logits "
                             "at low res: build the model with fast_gating_pool")
        if (qexperts["trunk"], qexperts["stem_kind"]) != (trunk, stem):
            raise ValueError(f"qexperts were prepared for trunk {qexperts['trunk']!r}, stem "
                             f"{qexperts['stem_kind']!r}; this forward runs {trunk!r}, {stem!r}")
        image = batch["image"].to(dtype).permute(0, 3, 1, 2)  # NHWC → NCHW
        B = image.shape[0]
        context_features = model.context_features(batch, B, dtype, image.device)
        stems = qexperts["stem"](image, stem_variant) if "stem" in qexperts else None
        expert_outputs = []
        for i, (ecfg, expert) in enumerate(zip(config.experts, model.experts)):
            if stems is None:  # the v1 trunk, or the "solo" stem
                feats = own_stem_trunk(qexperts["experts"][i], scales[i], image, dtype, trunk)
            else:
                feats = resnet_quant_forward_q8(qexperts["trunks"][i], scales[i], stems[i],
                                                dtype=dtype)
            feats = feats.permute(0, 3, 1, 2)  # [B,512,h,w]
            if ecfg.type == "nuscenes":
                lidar = (lidar_or_zeros(batch, B, dtype, image.device)
                         if ecfg.use_lidar else None)
                expert_outputs.append(expert.heads(feats.mean(dim=(2, 3)), lidar))
            else:
                expert_outputs.append(expert.heads(feats))
        features = model.extractor_features(expert_outputs, image.shape[2:])
        out = model.head_outputs(image, features, context_features, noise=False)
        return {k: out[k] for k in ("waypoints", "speed", "speed_seq",
                                    "expert_weights", "combined_features",
                                    "gate_logits")}

    return forward


# ---------------------------------------------------------------------------
# One standalone expert (the eval CLI's `bdd --quantize`)
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantize_expert(expert, calib_images: Sequence, dtype=torch.bfloat16,
                    float_convs: frozenset = DEFAULT_FLOAT_CONVS,
                    backbone: str = "backbone"):
    """(qpack, scales) for ONE standalone expert (BDD detection,
    segmentation or drivable): the per-expert counterpart of
    `quantize_automoe`, so the expert evals can measure the int8 task
    metrics against the float ones. Folds from the expert's float32
    weights; calibrates on NHWC images (numpy or tensors), run on the
    expert's device."""
    folded = fold_resnet(getattr(expert, backbone))
    device = next(expert.parameters()).device
    scales: Dict[str, float] = {}
    for img in calib_images:
        image = torch.as_tensor(img, device=device).to(dtype).permute(0, 3, 1, 2)
        c: Dict[str, torch.Tensor] = {}
        resnet_float_forward(folded, image, dtype=dtype, collect=c)
        for k, v in c.items():
            scales[k] = max(scales.get(k, 0.0), float(v))
    return quantize_folded(folded, float_convs), scales


def prepare_qexpert(qpack: Dict, scales: Dict[str, float], dtype=torch.bfloat16,
                    device="cpu", trunk: str = "q8") -> Dict:
    """Device-side constants of one expert's quantized pack (from
    `quantize_expert`, or one expert of `quantize_automoe`): its float
    stem conv (OIHW, in `dtype`) and its int8 trunk (`pack_trunk`)."""
    p = next(_float_stems([qpack]))
    return {"stem_w": torch.from_numpy(p["w"]).to(device, dtype),
            "stem_b": torch.from_numpy(p["b"]).to(device, dtype),
            "trunk": pack_trunk(qpack, scales, device, trunk)}


def float_stem(qexpert: Dict, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """An expert's own float stem over NCHW x: the 7x7/s2 conv + bias in
    `dtype`, ReLU, the 3x3/s2 SAME max-pool (-inf padding) → NCHW."""
    h = F.conv2d(x.to(dtype), qexpert["stem_w"], stride=2, padding=3) \
        + qexpert["stem_b"][:, None, None]
    return F.max_pool2d(torch.relu(h), 3, 2, 1)


def float_stem_q8(qexpert: Dict, scales: Dict[str, float], x: torch.Tensor,
                  dtype=torch.bfloat16):
    """The q8 trunk's own float stem, for an expert served alone or the
    "solo" stem (the JAX package's resnet_quant_forward_q8 with
    stem_in=None): `float_stem`, then the int8 domain at layer1_0/conv1's
    scale. x NCHW → (xq int8 NHWC, si)."""
    h = float_stem(qexpert, x, dtype)
    si = _act_scale(scales["layer1_0/conv1"])
    return _quant(h.float().permute(0, 2, 3, 1).contiguous(), si), si


def own_stem_trunk(qexpert: Dict, scales: Dict[str, float], x: torch.Tensor, dtype,
                   trunk: str = "q8") -> torch.Tensor:
    """One expert's int8 trunk behind its own float stem, from
    `prepare_qexpert` with the same `trunk`: x NCHW → NHWC features."""
    if trunk == "v1":
        return resnet_quant_forward(qexpert, x, dtype)
    return resnet_quant_forward_q8(qexpert["trunk"], scales,
                                   float_stem_q8(qexpert, scales, x, dtype), dtype=dtype)


def make_expert_quant_apply(task: str, num_classes: int, scales: Dict[str, float],
                            dtype=torch.bfloat16, trunk: str = "q8"):
    """fn(expert, qexpert, image) with the output contract of the float
    expert module's forward over an int8 trunk, image NCHW: detection →
    {class_logits, bbox_deltas} on the dense grid; segmentation and drivable
    → [B,C,H,W] logits resized to the image (ops/resize.py, bilinear, no
    antialias). `expert` is the float module (its head or decoder runs, in
    the module's dtype, which should be `dtype`); `qexpert` comes from
    `prepare_qexpert` with the same `trunk` ("q8" or "v1"). Plugs into
    evaluate_detection / evaluate_seg_like with
    functools.partial(fn, expert, qexpert)."""
    _check_trunk_stem(trunk, "solo")
    if task not in ("detection", "segmentation", "drivable"):
        raise ValueError(f"unknown task {task!r}")
    from automoe_tpu_torch.models.experts import bilinear_resize

    @torch.no_grad()
    def apply_fn(expert, qexpert: Dict, image: torch.Tensor):
        if expert.num_classes != num_classes:
            raise ValueError(f"the expert has {expert.num_classes} classes, not {num_classes}")
        feats = own_stem_trunk(qexpert, scales, image, dtype, trunk).permute(0, 3, 1, 2)
        out = expert.heads(feats)
        if task == "detection":
            return out
        return bilinear_resize(out, image.shape[2], image.shape[3])

    return apply_fn
