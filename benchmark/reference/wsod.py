"""The plain reference of a UniT base-training step (arXiv:2006.07502),
written from the recipe's mathematics: detectron2's Faster R-CNN C4
(ResNet with frozen batch norm, RPN, ROIAlignV2, a Res5 head), WSDDN's
two-stream MIL and OICR's refinements on the weak stream, Mask R-CNN's
mask head, SGD with momentum.  It is a set of functions over a dict of
tensors (the parameters and buffers, under the names the port's state dict
uses, so that one dict loads into both), and it imports nothing of the
program.

Precision is the configuration's (TPU.COMPUTE_DTYPE): convolutions, their
activations and ROIAlign's output in bfloat16, each frozen batch norm
computed in float32 and rounded once; the heads, losses and update in
float32; TF32 off.  ``fake_fp8`` runs it as the control, one precision below:
every convolution on float8-rounded inputs and weights and every batch
norm's output rounded to float8.

What the recipe leaves random is drawn as the port draws it, from the
generator of the step (seeded ``step_seed``): per strong image a uniform key
per anchor for the RPN's sample, then per strong image a uniform key per
candidate ROI for the box head's sample; a group's first ``k`` by key,
ties to the lower index, are sampled."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# the values the two recipes leave at the defaults of detectron2 and UniT
DEFAULTS = {
    "MODEL.PIXEL_MEAN": [103.53, 116.28, 123.675],
    "MODEL.PIXEL_STD": [1.0, 1.0, 1.0],
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 256,
    "MODEL.BACKBONE.FREEZE_AT": 2,
    "MODEL.ANCHOR_GENERATOR.SIZES": [[32, 64, 128, 256, 512]],
    "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS": [[0.5, 1.0, 2.0]],
    "MODEL.RPN.IOU_THRESHOLDS": [0.3, 0.7],
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 256,
    "MODEL.RPN.POSITIVE_FRACTION": 0.5,
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 12000,
    "MODEL.RPN.POST_NMS_TOPK_TRAIN": 2000,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 6000,
    "MODEL.RPN.POST_NMS_TOPK_TEST": 1000,
    "MODEL.RPN.NMS_THRESH": 0.7,
    "MODEL.ROI_HEADS.IOU_THRESHOLDS": [0.5],
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 512,
    "MODEL.ROI_HEADS.POSITIVE_FRACTION": 0.25,
    "MODEL.ROI_HEADS.WEAK_CLASSIFIER_PROPOSAL_DIVISOR": 1,
    "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.OICR_ITER": 3,
    "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.BG_THRESHOLD": 0.1,
    "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.CLASSIFIER_TEMP": 1.0,
    "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.DETECTOR_TEMP": 1.0,
    "MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS": [10.0, 10.0, 5.0, 5.0],
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 14,
    "TPU.ROI_ALIGN_SAMPLING_RATIO": 2,
    "TPU.COMPUTE_DTYPE": "bfloat16",
    "TPU.MAX_GT_BOXES": 100,
    "SOLVER.MOMENTUM": 0.9,
    "SOLVER.WEIGHT_DECAY": 0.0001,
    "SOLVER.WEIGHT_DECAY_BIAS": 0.0001,
    "SOLVER.WARMUP_FACTOR": 0.001,
    "SOLVER.GAMMA": 0.1,
}
BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FP8_MAX = 448.0  # the largest finite float8 e4m3 value
BN_EPS = 1e-5
SCALE_CLAMP = math.log(1000.0 / 16.0)
RPN_DIM = 1024  # the RPN's 3x3 convolution: as wide as the C4 map of the published widths


def _parse(v):
    """A tuple written as a string ("(480, 512)") as a list of numbers."""
    if isinstance(v, str) and v.startswith("(") and "'" not in v:
        return [float(x) if "." in x else int(x) for x in v.strip("()").split(",") if x.strip()]
    return v


class Recipe:
    """The values of a benchmark configuration file (``recipe``, then
    ``changed``, then ``DEFAULTS``) that the step reads."""

    def __init__(self, config: dict, precision: str = ""):
        self.v = dict(DEFAULTS)
        for part in ("recipe", "changed"):
            self.v.update({k: _parse(x) for k, x in config[part].items()})
        if precision:
            self.v["TPU.COMPUTE_DTYPE"] = precision
        g = self.v.__getitem__
        self.depth = int(g("MODEL.RESNETS.DEPTH"))
        self.res2 = int(g("MODEL.RESNETS.RES2_OUT_CHANNELS"))
        self.c = int(g("MODEL.ROI_HEADS.NUM_CLASSES"))
        self.novel = list(g("DATASETS.FEWSHOT.NOVEL_CLASSES_ID"))
        self.base = list(g("DATASETS.FEWSHOT.BASE_CLASSES_ID"))
        self.two_heads = bool(g("MODEL.ROI_HEADS.MULTI_BOX_HEAD"))
        self.masks = bool(g("MODEL.MASK_ON"))
        self.dtype = torch.bfloat16 if g("TPU.COMPUTE_DTYPE") == "bfloat16" else torch.float32
        self.pool = int(g("MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"))
        self.ratio = int(g("TPU.ROI_ALIGN_SAMPLING_RATIO"))
        self.rois = int(g("MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"))
        self.fg_frac = float(g("MODEL.ROI_HEADS.POSITIVE_FRACTION"))
        self.weak_rois = self.rois // int(g("MODEL.ROI_HEADS.WEAK_CLASSIFIER_PROPOSAL_DIVISOR"))
        wd = "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR."
        self.oicr = int(g(wd + "OICR_ITER"))
        self.bg_thresh = float(g(wd + "BG_THRESHOLD"))
        self.cls_temp = float(g(wd + "CLASSIFIER_TEMP"))
        self.det_temp = float(g(wd + "DETECTOR_TEMP"))
        self.sizes = [float(s) for s in g("MODEL.ANCHOR_GENERATOR.SIZES")[0]]
        self.ratios = [float(a) for a in g("MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS")[0]]
        self.anchors_per_cell = len(self.sizes) * len(self.ratios)

    def __getitem__(self, key):
        return self.v[key]


# ------------------------------------------------------------------ parameters
def _resnet_convs(prefix: str, blocks: int, cin: int, cout: int, stride: int):
    """(name, in, out, k, stride) of one ResNet stage's convolutions."""
    out = []
    for i in range(blocks):
        b = f"{prefix}.block{i}"
        mid, src = cout // 4, cin if i == 0 else cout
        s = stride if i == 0 else 1
        out += [(b + ".conv1", src, mid, 1, s), (b + ".conv2", mid, mid, 3, 1),
                (b + ".conv3", mid, cout, 1, 1)]
        if i == 0:
            out.append((b + ".shortcut", src, cout, 1, s))
    return out


def _backbone_convs(r: Recipe):
    n = BLOCKS[r.depth]
    convs = [("backbone.stem_conv1", 3, 64, 7, 2)]
    cin, cout = 64, r.res2
    for k, stage in enumerate(("res2", "res3", "res4")):
        convs += _resnet_convs("backbone." + stage, n[k], cin, cout, 1 if k == 0 else 2)
        cin, cout = cout, cout * 2
    return convs, cin


def _head_convs(r: Recipe, head: str, cin: int):
    return _resnet_convs(head + ".res5", BLOCKS[r.depth][3], cin, r.res2 * 8, 2)


def heads(r: Recipe) -> List[str]:
    return ["box_head"] + (["weak_box_head"] if r.two_heads else [])


def param_specs(r: Recipe) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every parameter in draw order: std is the
    normal's (lecun normal for convolutions and dense layers, 0.01 for the
    RPN head, 0.001 for the box-delta and mask predictors, He normal over
    the output for the transposed convolution, zero for the supervised
    classifier delta and every bias)."""
    convs, c4 = _backbone_convs(r)
    for h in heads(r):
        convs += _head_convs(r, h, c4)
    out = [(n + ".weight", (o, i, k, k), 1.0 / math.sqrt(i * k * k)) for n, i, o, k, _ in convs]
    a = r.anchors_per_cell
    for name, i, o, k in (("conv", c4, RPN_DIM, 3), ("objectness_logits", RPN_DIM, a, 1),
                          ("anchor_deltas", RPN_DIM, 4 * a, 1)):
        out += [(f"rpn_head.{name}.weight", (o, i, k, k), 0.01),
                (f"rpn_head.{name}.bias", (o,), 0.0)]
    d, c = r.res2 * 8, r.c
    dense = [("supervised.cls_score_delta", c + 1, 0.0),
             ("supervised.bbox_pred_delta", 4 * c, 0.001),
             ("weak_detector.classifier_stream", c, None),
             ("weak_detector.detection_stream", c, None)]
    dense += [(f"weak_detector.oicr_predictor_{k}", c + 1, None) for k in range(r.oicr)]
    for name, o, std in dense:
        out += [(name + ".weight", (o, d), 1.0 / math.sqrt(d) if std is None else std),
                (name + ".bias", (o,), 0.0)]
    if r.masks:
        out += [("mask_head.deconv.weight", (d, 256, 2, 2), math.sqrt(2.0 / (256 * 4))),
                ("mask_head.deconv.bias", (256,), 0.0),
                ("mask_head.predictor.weight", (c, 256, 1, 1), 0.001),
                ("mask_head.predictor.bias", (c,), 0.0)]
    return out


def batch_norms(r: Recipe) -> List[Tuple[str, int]]:
    """(name, channels) of every frozen batch norm: one after each convolution
    of the backbone and the Res5 heads."""
    convs, c4 = _backbone_convs(r)
    for h in heads(r):
        convs += _head_convs(r, h, c4)
    return [(n + "_bn", o) for n, _, o, _, _ in convs]


def make_state(r: Recipe, seed: int, device, embeddings: np.ndarray) -> Dict[str, torch.Tensor]:
    """Every parameter from one standard normal draw on ``device`` (a
    generator seeded with ``seed``), scaled by its std; the batch norms the
    identity; the class embeddings given.  ``calibrate`` then sets the batch
    norms' statistics."""
    specs = param_specs(r)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in specs), generator=gen, device=device)
    state, at = {}, 0
    for name, shape, std in specs:
        n = math.prod(shape)
        state[name] = (flat[at:at + n].view(shape) * std).contiguous()
        at += n
    for name, ch in batch_norms(r):
        for k, v in (("weight", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            state[f"{name}.{k}"] = torch.full((ch,), v, device=device)
    state["embeddings"] = torch.as_tensor(embeddings[:80], dtype=torch.float32, device=device)
    return state


def trainable(r: Recipe, state: Dict[str, torch.Tensor]) -> List[str]:
    """The parameters an update moves: all but the batch norms, the class
    embeddings and the stages up to BACKBONE.FREEZE_AT (the stem, res2)."""
    last = int(r["MODEL.BACKBONE.FREEZE_AT"])
    frozen = ["backbone.stem"] + [f"backbone.res{k}." for k in range(2, last + 1)]
    return [n for n, _, _ in param_specs(r) if not any(n.startswith(f) for f in frozen)]


# ------------------------------------------------------------------ layers
def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude to
    FP8_MAX), in ``t``'s dtype; the gradient passes straight through."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


class Net:
    """The step's forward pass over ``state`` at ``r``'s precision.
    ``calibrate``: each batch norm first takes the per-channel mean and
    variance of its own input (no gradient)."""

    def __init__(self, r: Recipe, state: Dict[str, torch.Tensor], fp8: bool = False,
                 calibrate: bool = False):
        self.r, self.s, self.fp8, self.calibrate = r, state, fp8, calibrate
        self.dt = r.dtype

    def conv(self, x, name, stride=1, padding=0, bias=False):
        w = self.s[name + ".weight"].to(self.dt)
        b = self.s[name + ".bias"].to(self.dt) if bias else None
        x = x.to(self.dt)
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        return F.conv2d(x, w, b, stride, padding)

    def bn(self, x, name, relu=True, residual=None):
        s = self.s
        if self.calibrate:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
                s[name + ".mean"].copy_(mean)
                s[name + ".var"].copy_(var)
        scale = s[name + ".weight"] / torch.sqrt(s[name + ".var"] + BN_EPS)
        shift = s[name + ".bias"] - s[name + ".mean"] * scale
        y = x.float() * scale[:, None, None] + shift[:, None, None]
        if residual is not None:
            y = y + residual.float()
        if relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
        return fake_fp8(y) if self.fp8 else y

    def stage(self, x, prefix, blocks, stride):
        for i in range(blocks):
            b = f"{prefix}.block{i}"
            s = stride if i == 0 else 1
            out = self.bn(self.conv(x, b + ".conv1", s), b + ".conv1_bn")
            out = self.bn(self.conv(out, b + ".conv2", 1, 1), b + ".conv2_bn")
            sc = x if i else self.bn(self.conv(x, b + ".shortcut", s), b + ".shortcut_bn", relu=False)
            x = self.bn(self.conv(out, b + ".conv3"), b + ".conv3_bn", residual=sc)
        return x

    def backbone(self, images):
        """BGR images [B, H, W, 3] (0-255) -> stride-16 map [B, C, h, w]."""
        r = self.r
        mean = torch.tensor(r["MODEL.PIXEL_MEAN"], device=images.device)
        std = torch.tensor(r["MODEL.PIXEL_STD"], device=images.device)
        x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
        x = self.bn(self.conv(x, "backbone.stem_conv1", 2, 3), "backbone.stem_conv1_bn")
        x = F.max_pool2d(x, 3, 2, 1)
        n = BLOCKS[r.depth]
        for k, stage in enumerate(("res2", "res3", "res4")):
            x = self.stage(x, "backbone." + stage, n[k], 1 if k == 0 else 2)
        return x

    def rpn(self, feats):
        """-> objectness [B, h*w*A] and deltas [B, h*w*A, 4], float32, in
        (row, column, anchor) order."""
        t = torch.relu(self.conv(feats, "rpn_head.conv", 1, 1, bias=True))
        obj = self.conv(t, "rpn_head.objectness_logits", bias=True)
        dl = self.conv(t, "rpn_head.anchor_deltas", bias=True)
        b = obj.shape[0]
        return (obj.permute(0, 2, 3, 1).reshape(b, -1).float(),
                dl.permute(0, 2, 3, 1).reshape(b, -1, 4).float())

    def res5(self, pooled, head):
        """pooled ROIs [N, C, P, P] -> the head's map [N, 2048, P/2, P/2]."""
        return self.stage(pooled, head + ".res5", BLOCKS[self.r.depth][3], 2)

    def dense(self, x, name):
        return F.linear(x, self.s[name + ".weight"], self.s[name + ".bias"])

    def mask_logits(self, x):
        """Res5 maps [N, 2048, 7, 7] -> per-class mask logits [N, C, 14, 14]."""
        w = self.s["mask_head.deconv.weight"].to(self.dt)
        x = x.to(self.dt)
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        x = torch.relu(F.conv_transpose2d(x, w, self.s["mask_head.deconv.bias"].to(self.dt), 2))
        return self.conv(x, "mask_head.predictor", bias=True).float()


# ------------------------------------------------------------------ boxes
def anchors(h: int, w: int, r: Recipe, device) -> torch.Tensor:
    """[h*w*A, 4] anchors in (row, column, anchor) order: for each size, for
    each aspect ratio a = h/w, a box of that area centred on the cell's
    top-left corner (offset 0), cells 16 pixels apart."""
    cell = []
    for size in r.sizes:
        for ar in r.ratios:
            bw = math.sqrt(size * size / ar)
            bh = ar * bw
            cell.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device) * 16
    xs = torch.arange(w, dtype=torch.float32, device=device) * 16
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    shift = torch.stack([sx, sy, sx, sy], -1)
    return (shift[:, :, None, :] + cell[None, None]).reshape(-1, 4)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, N] intersection over union of XYXY boxes; 0 for an empty union."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    wh = (torch.minimum(a[:, None, 2:], b[None, :, 2:])
          - torch.maximum(a[:, None, :2], b[None, :, :2])).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def encode(src: torch.Tensor, dst: torch.Tensor, weights) -> torch.Tensor:
    """The deltas (dx, dy, dw, dh) that take boxes ``src`` to ``dst``."""
    sw, sh = src[:, 2] - src[:, 0], src[:, 3] - src[:, 1]
    dw, dh = dst[:, 2] - dst[:, 0], dst[:, 3] - dst[:, 1]
    wx, wy, ww, wh = weights
    return torch.stack([wx * ((dst[:, 0] + 0.5 * dw) - (src[:, 0] + 0.5 * sw)) / sw,
                        wy * ((dst[:, 1] + 0.5 * dh) - (src[:, 1] + 0.5 * sh)) / sh,
                        ww * torch.log(dw / sw), wh * torch.log(dh / sh)], -1)


def decode(deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Boxes ``boxes`` moved by ``deltas`` (weights 1), the size deltas
    clamped at log(1000 / 16)."""
    w, h = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    cx, cy = boxes[:, 0] + 0.5 * w, boxes[:, 1] + 0.5 * h
    px, py = deltas[:, 0] * w + cx, deltas[:, 1] * h + cy
    pw = torch.exp(deltas[:, 2].clamp_max(SCALE_CLAMP)) * w
    ph = torch.exp(deltas[:, 3].clamp_max(SCALE_CLAMP)) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def nms(boxes: torch.Tensor, thresh: float, cap: int) -> torch.Tensor:
    """Greedy NMS over score-ordered boxes [N, 4]: a box is kept unless a
    kept box before it overlaps it by IoU > ``thresh``; the indices of the
    first ``cap`` kept."""
    n = boxes.shape[0]
    over = np.zeros((n, n), bool)
    for lo in range(0, n, 2048):
        over[lo:lo + 2048] = (iou(boxes[lo:lo + 2048], boxes) > thresh).cpu().numpy()
    removed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if removed[i]:
            continue
        keep.append(i)
        if len(keep) == cap:
            break
        removed |= over[i]
    return torch.as_tensor(keep, dtype=torch.long, device=boxes.device)


def proposals(logits, deltas, anc, size, r: Recipe, train: bool = True):
    """One image's proposals: the top PRE_NMS_TOPK anchors by objectness
    (ties to the lower index), moved by their deltas, clipped to the image
    (``size`` = (h, w)), the non-empty ones through NMS at NMS_THRESH, the
    first POST_NMS_TOPK kept in score order.  Boxes [K, 4] and valid [K],
    K = min(PRE, POST), invalid slots zero."""
    mode = "TRAIN" if train else "TEST"
    pre = min(int(r[f"MODEL.RPN.PRE_NMS_TOPK_{mode}"]), logits.shape[0])
    post = int(r[f"MODEL.RPN.POST_NMS_TOPK_{mode}"])
    order = torch.sort(logits, descending=True, stable=True).indices[:pre]
    b = decode(deltas[order], anc[order])
    h, w = float(size[0]), float(size[1])
    b = torch.stack([b[:, 0].clamp(0, w), b[:, 1].clamp(0, h),
                     b[:, 2].clamp(0, w), b[:, 3].clamp(0, h)], -1)
    ok = ((b[:, 2] - b[:, 0]) > 0) & ((b[:, 3] - b[:, 1]) > 0) & torch.isfinite(logits[order])
    cand = torch.nonzero(ok).flatten()
    kept = cand[nms(b[cand], float(r["MODEL.RPN.NMS_THRESH"]), post)]
    k = min(pre, post)
    out = torch.zeros((k, 4), device=b.device)
    valid = torch.zeros(k, dtype=torch.bool, device=b.device)
    out[:len(kept)] = b[kept]
    valid[:len(kept)] = True
    return out, valid


def sample(keys: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, n: int, frac: float):
    """At most ``n`` members, at most ``frac`` of them from ``pos``: each
    group's members with the largest ``keys`` (ties to the lower index)."""
    def first(member, k):
        order = torch.sort(torch.where(member, keys, -1.0), descending=True, stable=True).indices
        sel = torch.zeros_like(member)
        sel[order[:k]] = True
        return sel & member

    n_pos = min(int(pos.sum()), int(n * frac))
    n_neg = min(int(neg.sum()), n - n_pos)
    return first(pos, n_pos), first(neg, n_neg)


# ------------------------------------------------------------------ ROIAlign
def _axis(lo, hi, size, p, s):
    """Each ROI's [N, P, size] weights along one axis: the mean over the
    bin's ``s`` sample points of their linear-interpolation weights (zero
    for a point beyond one pixel outside the map, clamped inside)."""
    grid = (torch.arange(p, device=lo.device, dtype=torch.float32)[:, None]
            + (torch.arange(s, device=lo.device, dtype=torch.float32) + 0.5)
            / torch.full((), float(s), device=lo.device))
    div = torch.full((), float(p), device=lo.device)
    pos = lo[:, None, None] + ((hi - lo) / div)[:, None, None] * grid
    inside = ((pos >= -1) & (pos <= size)).float()
    v = pos.clamp(0, size - 1)
    v0 = v.floor()
    frac = v - v0
    v1 = (v0 + 1).clamp_max(size - 1)
    w = ((1 - frac)[..., None] * F.one_hot(v0.long(), size)
         + frac[..., None] * F.one_hot(v1.long(), size)) * inside[..., None]
    return w.sum(2) / s


def _pool_chunk(fmap, wy, wx):
    t = (wy.reshape(-1, wy.shape[-1]) @ fmap.float().flatten(1)).view(
        wy.shape[0], wy.shape[1], fmap.shape[1], fmap.shape[2])
    return torch.einsum("nqw,npwc->npqc", wx, t)


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor, r: Recipe, chunk: int = 64):
    """ROIAlignV2 of one image: map [H, W, C], boxes [N, 4] in pixels ->
    [N, C, P, P] in the map's dtype: each bin the mean of ``s`` x ``s``
    bilinear samples, the box scaled by 1/16 and shifted by half a pixel.
    As two matrix products per ROI (rows, then columns), so its gradient is
    the transposed products."""
    h, w = fmap.shape[:2]
    p, s = r.pool, r.ratio
    b = boxes.float() / 16.0 - 0.5
    wy = _axis(b[:, 1], b[:, 3], h, p, s)
    wx = _axis(b[:, 0], b[:, 2], w, p, s)
    out = []
    for lo in range(0, boxes.shape[0], chunk):
        args = (fmap, wy[lo:lo + chunk], wx[lo:lo + chunk])
        out.append(checkpoint(_pool_chunk, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _pool_chunk(*args))
    return torch.cat(out).to(fmap.dtype).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ losses
def rpn_losses(gen, logits, deltas, anc, gt_boxes, gt_valid, r: Recipe):
    """Per image: anchors labelled 1 at IoU >= 0.7 with a ground-truth box
    or at a box's best IoU, 0 below 0.3; 256 sampled, at most half positive;
    binary cross-entropy and the L1 of the box deltas, both summed over the
    sample and divided by 256 x images."""
    b = logits.shape[0]
    lo_t, hi_t = r["MODEL.RPN.IOU_THRESHOLDS"]
    n_s = int(r["MODEL.RPN.BATCH_SIZE_PER_IMAGE"])
    cls_sum = loc_sum = 0.0
    for i in range(b):
        g = gt_boxes[i][gt_valid[i]]
        q = iou(g, anc)
        best, match = q.max(0)
        label = torch.full_like(best, -1)
        label[best < lo_t] = 0
        label[best >= hi_t] = 1
        label[(q == q.max(1, keepdim=True).values).any(0)] = 1
        keys = torch.rand(anc.shape[0], generator=gen, device=anc.device)
        pos, neg = sample(keys, label == 1, label == 0, n_s,
                          float(r["MODEL.RPN.POSITIVE_FRACTION"]))
        x, t = logits[i], pos.float()
        bce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
        cls_sum = cls_sum + bce[pos | neg].sum()
        target = encode(anc[pos], g[match[pos]], (1.0, 1.0, 1.0, 1.0))
        loc_sum = loc_sum + (deltas[i][pos] - target).abs().sum()
    norm = float(b * n_s)
    return {"loss_rpn_cls": cls_sum / norm, "loss_rpn_loc": loc_sum / norm}


def sample_rois(gen, props, valid, gt_boxes, gt_classes, gt_valid, r: Recipe):
    """One strong image: its proposals and ground truth labelled (the GT
    box's class at IoU >= 0.5, background below), ROI_HEADS.BATCH_SIZE
    sampled with at most POSITIVE_FRACTION foreground; slots foreground
    first, then background, then the unsampled (invalid), each in index
    order.  Returns boxes, classes (background = C), matched GT boxes,
    matched GT index, valid and foreground flags of the slots."""
    c = r.c
    boxes = torch.cat([props, gt_boxes])
    ok = torch.cat([valid, gt_valid])
    q = iou(gt_boxes, boxes)
    q = torch.where(gt_valid[:, None], q, -1.0)
    best, match = q.max(0)
    cls = torch.where(best >= r["MODEL.ROI_HEADS.IOU_THRESHOLDS"][0],
                      gt_classes.long()[match], c)
    fg, bg = ok & (cls < c), ok & (cls == c)
    keys = torch.rand(boxes.shape[0], generator=gen, device=boxes.device)
    pos, neg = sample(keys, fg, bg, r.rois, r.fg_frac)
    idx = torch.arange(boxes.shape[0], device=boxes.device)
    rank = torch.where(pos, 0, torch.where(neg, 1, 2)) * boxes.shape[0] + idx
    order = torch.sort(rank).indices[:r.rois]
    used = (pos | neg)[order]
    return {"boxes": boxes[order], "classes": torch.where(used, cls[order], c),
            "gt": gt_boxes[match[order]], "gt_index": match[order], "valid": used,
            "fg": pos[order]}


def box_mask_targets(masks, gt, rois, m: int):
    """Each ROI's M x M mask target: its GT mask (given in its GT box's frame)
    sampled bilinearly at the centres of the ROI's grid, > 0.5; zero where a
    centre lies beyond one cell outside the GT mask."""
    g = masks.shape[-1]
    grid = (torch.arange(m, device=masks.device, dtype=torch.float32) + 0.5) / m
    gw = (gt[:, 2] - gt[:, 0]).clamp_min(1e-4)
    gh = (gt[:, 3] - gt[:, 1]).clamp_min(1e-4)
    xs = rois[:, 0:1] + grid * (rois[:, 2:3] - rois[:, 0:1])
    ys = rois[:, 1:2] + grid * (rois[:, 3:4] - rois[:, 1:2])
    fx = (xs - gt[:, 0:1]) / gw[:, None] * g - 0.5
    fy = (ys - gt[:, 1:2]) / gh[:, None] * g - 0.5

    def weights(f):  # [N, M] -> [N, M, G] interpolation weights, zero outside
        inside = ((f >= -1) & (f <= g)).float()
        v0 = f.floor().clamp(0, g - 1)
        v1 = (v0 + 1).clamp(0, g - 1)
        t = (f - v0).clamp(0, 1)
        return ((1 - t)[..., None] * F.one_hot(v0.long(), g)
                + t[..., None] * F.one_hot(v1.long(), g)) * inside[..., None]

    val = torch.einsum("nyg,ngh,nxh->nyx", weights(fy), masks.float(), weights(fx))
    return (val > 0.5).float()


def mil_oicr_losses(streams, boxes, valid, labels, r: Recipe, record: Optional[list] = None):
    """The weak stream's losses.  MIL: softmax over classes times softmax
    over the image's proposals, summed over proposals, against the labels
    by binary cross-entropy (clamped to [1e-6, 1 - 1e-6], mean over images
    and classes).  OICR k: each labelled class, in ascending order, takes
    the proposal that scores highest under the previous stage (MIL, then
    refinement k-1), not taken by an earlier class, as a pseudo box with
    that score as weight; each proposal takes the class of the pseudo box
    it overlaps most at IoU >= 0.5 (else background), weighted by that box's
    score (zero under IoU 0.1); weighted cross-entropy, mean over an image's
    proposals, then over images."""
    b, c = labels.shape
    p = boxes.shape[1]
    cls = streams["cls"].view(b, p, c)
    det = streams["det"].view(b, p, c).masked_fill(~valid[..., None], float("-inf"))
    x = torch.softmax(cls, -1) * torch.softmax(det, 1).nan_to_num(0.0)
    x = torch.where(valid[..., None], x, 0.0)
    im = x.sum(1).clamp(1e-6, 1 - 1e-6)
    out = {"loss_im_cls": -(labels * im.log() + (1 - labels) * (1 - im).log()).mean()}
    prev = x.detach()
    for k in range(r.oicr):
        logit = streams["oicr"][k].view(b, p, c + 1)
        per = []
        for i in range(b):
            score = torch.where(valid[i][:, None], prev[i, :, :c], -1.0).clone()
            pb, ps, pc = [], [], []
            for cl in torch.nonzero(labels[i] > 0.5).flatten().tolist():
                j = int(torch.argmax(score[:, cl]))
                pb.append(boxes[i, j])
                ps.append(score[j, cl].clone())
                pc.append(cl)
                score[j] = 0.0
            if record is not None:
                record.append(torch.stack(pb).detach().cpu())
            q = iou(torch.stack(pb), boxes[i])
            best, m = q.max(0)
            tgt = torch.where(best >= r["MODEL.ROI_HEADS.IOU_THRESHOLDS"][0],
                              torch.tensor(pc, device=boxes.device)[m], c)
            wgt = torch.where(best < r.bg_thresh, 0.0, torch.stack(ps)[m])
            nll = -torch.log_softmax(logit[i], -1).gather(1, tgt[:, None])[:, 0]
            per.append(torch.where(valid[i], nll * wgt, 0.0).sum() / valid[i].sum().clamp_min(1))
        out[f"loss_oicr_{k + 1}"] = torch.stack(per).mean()
        prev = torch.softmax(logit, -1).detach()
    return out


# ------------------------------------------------------------------ the step
def losses(net: Net, gen, strong: dict, weak: dict,
           record: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The step's loss terms from the strong batch {image, image_size,
    gt_boxes, gt_classes, gt_valid[, gt_masks]} and the weak batch {image,
    image_size, labels} (one backbone pass over both where they share a
    canvas).  ``record``: lists ``sampled`` (each strong image's sampled
    boxes) and ``pseudo`` (each image's OICR pseudo boxes, a stage after
    another) are appended to."""
    r = net.r
    bs = strong["image"].shape[0]
    if strong["image"].shape[1:] == weak["image"].shape[1:]:
        fm = net.backbone(torch.cat([strong["image"], weak["image"]]))
        fs, fw = fm[:bs], fm[bs:]
        lg, dl = net.rpn(fm)
        (ls, lw), (ds, dw) = (lg[:bs], lg[bs:]), (dl[:bs], dl[bs:])
    else:
        fs, fw = net.backbone(strong["image"]), net.backbone(weak["image"])
        (ls, ds), (lw, dw) = net.rpn(fs), net.rpn(fw)
    anc_s = anchors(fs.shape[2], fs.shape[3], r, fs.device)
    anc_w = anchors(fw.shape[2], fw.shape[3], r, fw.device)
    with torch.no_grad():
        props_s = [proposals(ls[i].detach(), ds[i].detach(), anc_s, strong["image_size"][i], r)
                   for i in range(bs)]
        props_w = [proposals(lw[i].detach(), dw[i].detach(), anc_w, weak["image_size"][i], r)
                   for i in range(lw.shape[0])]
    out = rpn_losses(gen, ls, ds, anc_s, strong["gt_boxes"], strong["gt_valid"], r)

    # the strong stream: sampled ROIs, the box head, the supervised deltas on
    # the frozen mean OICR scores of the weak head, the novel classes masked
    samples = [sample_rois(gen, props_s[i][0], props_s[i][1], strong["gt_boxes"][i],
                           strong["gt_classes"][i], strong["gt_valid"][i], r) for i in range(bs)]
    if record is not None:
        record["sampled"] += [x["boxes"][x["valid"]].cpu() for x in samples]
    maps_s = fs.permute(0, 2, 3, 1)
    pooled = torch.cat([roi_align(maps_s[i], samples[i]["boxes"], r) for i in range(bs)])
    cat = {k: torch.cat([s[k] for s in samples]) for k in samples[0]}
    h5 = net.res5(pooled, "box_head")
    feats = h5.mean(dim=(2, 3)).float()
    with torch.no_grad():
        wf = net.res5(pooled, "weak_box_head").mean(dim=(2, 3)).float() if r.two_heads else feats
        weak_scores = torch.stack([net.dense(wf, f"weak_detector.oicr_predictor_{k}")
                                   for k in range(r.oicr)]).mean(0)
    scores = net.dense(feats, "supervised.cls_score_delta") + weak_scores
    scores[:, r.novel] = float("-inf")
    deltas = net.dense(feats, "supervised.bbox_pred_delta").view(-1, r.c, 4)
    n_valid = cat["valid"].sum()
    nll = -torch.log_softmax(scores, -1).gather(1, cat["classes"][:, None])[:, 0]
    out["loss_cls"] = torch.where(cat["valid"], nll, 0.0).sum() / n_valid
    fg = cat["fg"]
    own = deltas[fg, cat["classes"][fg]]
    target = encode(cat["boxes"][fg], cat["gt"][fg], r["MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS"])
    out["loss_box_reg"] = (own - target).abs().sum() / n_valid
    if r.masks:
        k = int(r.rois * r.fg_frac)
        n = h5.shape[0] // bs
        first = torch.cat([torch.arange(i * n, i * n + k, device=h5.device) for i in range(bs)])
        logits = net.mask_logits(h5[first])
        img = torch.arange(bs, device=h5.device).repeat_interleave(k)
        cls = cat["classes"][first].clamp_max(r.c - 1)
        own_m = logits[torch.arange(len(first), device=h5.device), cls]
        gm = strong["gt_masks"][img, cat["gt_index"][first]]
        t = box_mask_targets(gm, cat["gt"][first], cat["boxes"][first], own_m.shape[-1])
        bce = (own_m.clamp_min(0) - own_m * t + torch.log1p(torch.exp(-own_m.abs()))).mean((1, 2))
        fgm = cat["fg"][first]
        out["loss_mask"] = torch.where(fgm, bce, 0.0).sum() / fgm.sum()

    # the weak stream: its top proposals through the weak head, MIL + OICR
    nw = lw.shape[0]
    wb = torch.stack([p[0][:r.weak_rois] for p in props_w])
    wv = torch.stack([p[1][:r.weak_rois] for p in props_w])
    maps_w = fw.permute(0, 2, 3, 1)
    pooled_w = torch.cat([roi_align(maps_w[i], wb[i], r) for i in range(nw)])
    head = "weak_box_head" if r.two_heads else "box_head"
    wfe = net.res5(pooled_w, head).mean(dim=(2, 3)).float()
    streams = {"cls": net.dense(wfe, "weak_detector.classifier_stream") / r.cls_temp,
               "det": net.dense(wfe, "weak_detector.detection_stream") / r.det_temp,
               "oicr": [net.dense(wfe, f"weak_detector.oicr_predictor_{k}") for k in range(r.oicr)]}
    out.update(mil_oicr_losses(streams, wb, wv, weak["labels"].float(), r,
                               None if record is None else record["pseudo"]))
    return out


def step_seed(seed: int, step: int) -> int:
    """The sampling generator's seed of a step: the run's seed in the high 32
    bits, the step in the low."""
    return (int(seed) << 32) + int(step)


def lr_at(r: Recipe, count: int) -> float:
    """The learning rate of update ``count`` (0-based): linear warm-up from
    WARMUP_FACTOR over WARMUP_ITERS, GAMMA at each of STEPS."""
    warm_iters = int(r["SOLVER.WARMUP_ITERS"])
    alpha = min(count / warm_iters, 1.0) if warm_iters > 0 else 1.0
    f = float(r["SOLVER.WARMUP_FACTOR"])
    steps = r["SOLVER.STEPS"]
    return float(r["SOLVER.BASE_LR"]) * (f * (1 - alpha) + alpha) * float(r["SOLVER.GAMMA"]) ** sum(
        count >= s for s in steps)


@contextlib.contextmanager
def exact():
    """TF32 off and deterministic cuDNN for the reference's own work."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = old


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    return dict(zip(names, torch.stack([torch.linalg.vector_norm(tensors[n].double())
                                        for n in names]).tolist()))


def train(r: Recipe, state: Dict[str, torch.Tensor], batches: List[tuple], seed: int,
          fp8: bool = False, drop_half: bool = False, lr_scale: float = 1.0,
          nudge: bool = False, record: Optional[list] = None) -> dict:
    """The first ``len(batches)`` steps from ``state``: each step's losses,
    each trainable leaf's first gradient as SGD takes it (the global norm
    clipped to CLIP_VALUE, plus weight decay: the momentum buffer after one
    step), its change after the first step and after the last.  Faults for
    the limits' readings: ``drop_half`` leaves out each stream's second half
    of images, ``lr_scale`` scales every learning rate.  ``nudge`` (a witness
    of how the later steps take a rounding-level difference) moves every
    trainable element one float32 step up after the first update.
    ``record``: a step's sampled and pseudo boxes (``losses``) are appended
    to it, a dict a step."""
    s = {k: v.detach().clone() for k, v in state.items()}
    names = trainable(r, s)
    for n in names:
        s[n].requires_grad_(True)
    start = {n: s[n].detach().clone() for n in names}
    buf: Dict[str, torch.Tensor] = {}
    out = {"losses": [], "grad": None, "change1": None, "change": None}
    net = Net(r, s, fp8=fp8)
    mom, clip = float(r["SOLVER.MOMENTUM"]), float(r["SOLVER.CLIP_GRADIENTS.CLIP_VALUE"])
    with exact():
        for step, (strong, weak) in enumerate(batches):
            if drop_half:
                strong = {k: v[: len(v) // 2] for k, v in strong.items()}
                weak = {k: v[: len(v) // 2] for k, v in weak.items()}
            gen = torch.Generator(device=strong["image"].device)
            gen.manual_seed(step_seed(seed, step))
            seen = None if record is None else {"sampled": [], "pseudo": []}
            terms = losses(net, gen, strong, weak, seen)
            if record is not None:
                record.append(seen)
            total = torch.stack(list(terms.values())).sum()
            grads = torch.autograd.grad(total, [s[n] for n in names], allow_unused=True)
            grads = [torch.zeros_like(s[n]) if g is None else g for n, g in zip(names, grads)]
            if r["SOLVER.CLIP_GRADIENTS.ENABLED"]:
                norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                             for g in grads]))
                if norm >= clip:
                    grads = [g * (clip / norm) for g in grads]
            lr = lr_at(r, step) * lr_scale
            with torch.no_grad():
                for n, g in zip(names, grads):
                    decay = float(r["SOLVER.WEIGHT_DECAY_BIAS" if n.endswith("bias")
                                    else "SOLVER.WEIGHT_DECAY"])
                    d = g.add(s[n], alpha=decay)
                    buf[n] = d if step == 0 else buf[n].mul_(mom).add_(d)
                    s[n].add_(buf[n], alpha=-lr)
            if step == 0:
                out["grad"] = _norms(buf)
                out["change1"] = _norms({n: s[n].detach() - start[n] for n in names})
                if nudge:
                    with torch.no_grad():
                        for n in names:
                            s[n].copy_(torch.nextafter(s[n], torch.full_like(s[n], math.inf)))
            out["losses"].append({k: float(v.detach()) for k, v in terms.items()}
                                 | {"total_loss": float(total.detach())})
            del terms, total, grads
    out["change"] = _norms({n: s[n].detach() - start[n] for n in names})
    return out


def calibrate(r: Recipe, state: Dict[str, torch.Tensor], image: torch.Tensor) -> None:
    """Each batch norm's mean and variance become those of its own input, in
    order, over one float32 forward pass on ``image`` [1, H, W, 3]: the
    backbone, then each Res5 head over the image's test-time proposals."""
    r32 = Recipe.__new__(Recipe)
    r32.__dict__.update(r.__dict__, dtype=torch.float32)
    net = Net(r32, state, calibrate=True)
    h, w = image.shape[1:3]
    with torch.no_grad(), exact():
        fm = net.backbone(image)
        lg, dl = net.rpn(fm)
        anc = anchors(fm.shape[2], fm.shape[3], r32, fm.device)
        size = torch.tensor([h, w], dtype=torch.float32)
        boxes, valid = proposals(lg[0], dl[0], anc, size, r32, train=False)
        pooled = roi_align(fm.permute(0, 2, 3, 1)[0], boxes[valid], r32)
        for head in heads(r32):
            net.res5(pooled, head)
