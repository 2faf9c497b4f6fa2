"""The weakly-supervised R-CNN detector: serving path.

Port of unit_tpu/models/meta_arch.py:43-336,699-797 for inference with
``WeaklySupervisedRCNNNoMeta`` configs: ResNet-C4 -> RPN (+ NMS kernel) ->
ROIAlignV2 (kernel) -> one or two Res5 heads -> supervised delta heads + OICR
weak detector -> lingual/visual base->novel transfer -> softmax -> per-class
NMS (kernel).  Training, TTA, the weak-only path, masks and the meta stream
raise ``NotImplementedError`` naming the ROADMAP item that ports them.

Precision mirrors ``TPU.COMPUTE_DTYPE``: backbone, RPN convs and Res5 run in
the compute dtype; RPN outputs, box features and all predictor, transfer and
softmax math are f32; pooled features keep the feature dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import validate_registry_names
from ..ops import roi_align as roi_align_ops
from ..structures.instances import Detections, stack_fields
from . import fast_rcnn as frcnn
from . import rpn as rpn_lib
from . import similarity as sim_lib
from .predictors import (
    SupervisedPredictor,
    WeakDetectorPredictor,
    combine_cls_logits,
    transfer_deltas,
    transfer_scores,
)
from .resnet import Res5, ResNetC4

# TPU.ROI_ALIGN_IMPL / TPU.NMS_IMPL keep their meaning: the hand-written CUDA
# kernel takes the Pallas kernel's place, the plain PyTorch version XLA's.
_IMPLS = {"auto": "auto", "pallas": "cuda", "xla": "plain"}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to unit_tpu_torch yet ({item})")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration distilled from the CfgNode (predict path)."""

    meta_architecture: str = "WeaklySupervisedRCNNNoMeta"
    backbone_name: str = "build_resnet_backbone"
    box_head_name: str = "Res5BoxHead"
    depth: int = 50
    res2_out_channels: int = 256
    num_classes: int = 20
    base_ids: Tuple[int, ...] = ()
    novel_ids: Tuple[int, ...] = ()
    multi_box_head: bool = False
    pooler_resolution: int = 14
    pooler_scale: float = 1.0 / 16.0
    pooler_type: str = "ROIAlignV2"
    sampling_ratio: int = 2
    regression_branch: bool = False
    oicr_regression_branch: bool = False
    oicr_iter: int = 3
    finetune: bool = False
    weak_detector_finetune: bool = False
    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    normalize_images: bool = False
    compute_dtype: str = "float32"
    roi_align_impl: str = "auto"  # auto | cuda | plain
    nms_impl: str = "auto"        # auto | cuda | plain
    mask_on: bool = False
    load_proposals: bool = False
    use_meta: bool = False
    rpn: rpn_lib.RPNConfig = rpn_lib.RPNConfig()
    frcnn: frcnn.FastRCNNConfig = frcnn.FastRCNNConfig(num_classes=20)
    sim: sim_lib.SimilarityConfig = sim_lib.SimilarityConfig(
        terms=(("cls", ("lingual",)), ("bbox", ("lingual",))),
        base_ids=(), novel_ids=(), coco_indexer=(),
    )

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @classmethod
    def from_cfg(cls, cfg, class_names=None) -> "ModelConfig":
        validate_registry_names(cfg)
        num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        if class_names is None:
            class_names = (
                sim_lib.VOC_CLASSES if num_classes == 20
                else sim_lib.COCO_CLASSES[:num_classes]
            )
        wd = cfg.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR
        fast_name = cfg.MODEL.ROI_HEADS.FAST_RCNN.NAME
        return cls(
            meta_architecture=cfg.MODEL.META_ARCHITECTURE,
            backbone_name=cfg.MODEL.BACKBONE.NAME,
            box_head_name=cfg.MODEL.ROI_BOX_HEAD.NAME,
            depth=cfg.MODEL.RESNETS.DEPTH,
            res2_out_channels=cfg.MODEL.RESNETS.RES2_OUT_CHANNELS,
            num_classes=num_classes,
            base_ids=tuple(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID),
            novel_ids=tuple(cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID),
            multi_box_head=cfg.MODEL.ROI_HEADS.MULTI_BOX_HEAD,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            pooler_type=cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE,
            sampling_ratio=cfg.TPU.ROI_ALIGN_SAMPLING_RATIO,
            regression_branch=wd.REGRESSION_BRANCH,
            oicr_regression_branch=wd.OICR_REGRESSION_BRANCH,
            oicr_iter=wd.OICR_ITER,
            finetune="FineTune" in fast_name,
            weak_detector_finetune=wd.NAME == "WeakDetectorOutputsFT",
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            normalize_images=cfg.INPUT.NORMALIZE_IMAGES,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            roi_align_impl=_IMPLS.get(cfg.TPU.ROI_ALIGN_IMPL, cfg.TPU.ROI_ALIGN_IMPL),
            nms_impl=_IMPLS.get(cfg.TPU.NMS_IMPL, cfg.TPU.NMS_IMPL),
            mask_on=cfg.MODEL.MASK_ON,
            load_proposals=cfg.MODEL.LOAD_PROPOSALS,
            use_meta=cfg.MODEL.ROI_HEADS.NAME in ("WSROIHead", "WSROIHeadFineTuneMeta"),
            rpn=rpn_lib.RPNConfig.from_cfg(cfg),
            frcnn=frcnn.FastRCNNConfig.from_cfg(cfg),
            sim=sim_lib.SimilarityConfig.from_cfg(cfg, class_names),
        )


def _check_supported(mc: ModelConfig) -> None:
    if mc.backbone_name != "build_resnet_backbone":
        raise _not_ported(f"backbone {mc.backbone_name}", "ROADMAP Queue 1 item 25")
    if mc.box_head_name not in ("Res5BoxHead", "Res5BoxHeadNOTE", ""):
        raise _not_ported(f"box head {mc.box_head_name}", "ROADMAP Queue 1 item 25")
    if mc.pooler_type != "ROIAlignV2":
        raise _not_ported(f"pooler {mc.pooler_type}", "ROADMAP Queue 1 item 25")
    if mc.load_proposals:
        raise _not_ported("precomputed proposals", "ROADMAP Queue 1 item 25")
    if mc.meta_architecture == "WeakRCNN":
        raise _not_ported("the weak-only WeakRCNN", "ROADMAP Queue 1 item 20")
    if mc.finetune or mc.weak_detector_finetune:
        raise _not_ported("fine-tune heads", "ROADMAP Queue 1 item 19")
    if mc.regression_branch or mc.oicr_regression_branch or mc.oicr_iter < 1:
        raise _not_ported("weak regression branches and OICR_ITER 0",
                          "ROADMAP Queue 1 item 25")
    if mc.mask_on:
        raise _not_ported("the mask head", "ROADMAP Queue 1 item 22")
    if mc.use_meta:
        raise _not_ported("the meta (support) stream", "ROADMAP Queue 1 item 23")
    for impl in (mc.roi_align_impl, mc.nms_impl):
        if impl not in ("auto", "cuda", "plain"):
            raise ValueError(f"unknown kernel impl {impl!r} (auto | cuda | plain)")


class WSRCNN(nn.Module):
    """All parametric components of the detector, named after the flax tree.

    ``generator`` seeds the port's own initialisation, which follows flax's
    initialisers: lecun_normal convs, normal(0.01) RPN convs, the predictors'
    normal/zero Dense inits, identity FrozenBN, normal(0.02) embeddings (the
    GloVe table replaces them: checkpoint.embeddings).
    """

    def __init__(self, mc: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(mc)
        self.mc = mc
        g, dt = generator, mc.dtype
        self.backbone = ResNetC4(depth=mc.depth, res2_out_channels=mc.res2_out_channels,
                                 dtype=dt, generator=g)
        self.rpn_head = rpn_lib.RPNHead(self.backbone.out_channels, mc.rpn.num_cell_anchors,
                                        dtype=dt, generator=g)
        self.box_head = Res5(depth=mc.depth, res2_out_channels=mc.res2_out_channels,
                             dtype=dt, generator=g)
        if mc.multi_box_head:
            self.weak_box_head = Res5(depth=mc.depth, res2_out_channels=mc.res2_out_channels,
                                      dtype=dt, generator=g)
        d = self.box_head.out_channels
        self.supervised = SupervisedPredictor(d, mc.num_classes, generator=g)
        self.weak_detector = WeakDetectorPredictor(d, mc.num_classes,
                                                   oicr_iter=mc.oicr_iter, generator=g)
        emb = torch.empty(80, 300)
        with torch.no_grad():
            emb.normal_(0.0, 0.02, generator=g)
        self.register_buffer("embeddings", emb)

    # ---------------------------------------------------------------- pieces
    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """Optional /255, then caffe-style BGR mean/std, in f32."""
        x = images.to(torch.float32)
        if self.mc.normalize_images:
            x = x / 255.0
        mean = torch.tensor(self.mc.pixel_mean, device=x.device)
        std = torch.tensor(self.mc.pixel_std, device=x.device)
        return (x - mean) / std

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> res4 features [B, H/16, W/16, C] (a
        contiguous view of the channels_last backbone output)."""
        return self.backbone(self.preprocess(images)).permute(0, 2, 3, 1)

    def rpn(self, feats: torch.Tensor):
        return self.rpn_head(feats)

    def pooled_rois(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """feats [B, h, w, C], boxes [B, S, 4] -> [B*S, P, P, C] (feature dtype)."""
        mc = self.mc
        out = roi_align_ops.roi_align_batched(
            feats, boxes.contiguous(), mc.pooler_resolution, mc.pooler_scale,
            mc.sampling_ratio, impl=mc.roi_align_impl,
        )
        return out.reshape((-1,) + out.shape[2:])

    def box_features(self, pooled: torch.Tensor, head: str = "box") -> torch.Tensor:
        module = self.box_head if head == "box" else self.weak_box_head
        return module(pooled).to(torch.float32)

    def oicr_weight_mean(self) -> torch.Tensor:
        """Mean OICR classifier weight [C+1, D]."""
        return torch.stack([m.weight for m in self.weak_detector.oicr_predictors()]).mean(0)

    # ---------------------------------------------------------------- not ported
    def train_losses(self, *args, **kwargs):
        raise _not_ported("training", "ROADMAP Queue 1 slice B, items 8-13")

    def predict_tta(self, *args, **kwargs):
        raise _not_ported("test-time augmentation", "ROADMAP Queue 1 item 24")

    def predict_weak_only(self, *args, **kwargs):
        raise _not_ported("the weak-only predict path", "ROADMAP Queue 1 item 20")

    # ---------------------------------------------------------------- inference
    def inference_similarity(self, box_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Similarity matrices for the base->novel transfer."""
        weak_eval_scores, _ = self.weak_detector.evaluation(box_feats)
        needs_weights = any(
            t.split("-")[0] in ("TopK", "WTopK", "LSDA")
            for _, ts in self.mc.sim.terms for t in ts
        )
        return sim_lib.similarity_matrices(
            self.mc.sim,
            embeddings=self.embeddings,
            weak_eval_scores=weak_eval_scores,
            oicr_weight_mean=self.oicr_weight_mean() if needs_weights else None,
        )

    def predict_raw(self, images: torch.Tensor, image_sizes: torch.Tensor):
        """Everything of :meth:`predict` before the final NMS:
        ``(probs [B,P,C+1], bbox [B,P,C*4], proposals, feats)``; images
        [B, H, W, 3] f32 BGR, image_sizes [B, 2] (h, w) of the content."""
        mc = self.mc
        feats = self.features(images)
        logits, deltas = self.rpn(feats)
        anchors = rpn_lib.get_anchors(feats.shape[1], feats.shape[2], mc.rpn,
                                      device=feats.device)
        proposals = rpn_lib.select_proposals(logits, deltas, anchors, image_sizes, mc.rpn,
                                             nms_impl=mc.nms_impl)
        b, p = proposals.boxes.shape[:2]
        pooled = self.pooled_rois(feats, proposals.boxes)
        box_feats = self.box_features(pooled, "box")
        sup = self.supervised(box_feats)
        sup_weak_feats = self.box_features(pooled, "weak") if mc.multi_box_head else box_feats
        weak_scores, weak_box_deltas = self.weak_detector.evaluation(sup_weak_feats)

        delta_scores = sup["delta_scores"]
        proposal_deltas = sup["proposal_deltas"]
        if len(mc.novel_ids):
            sims = self.inference_similarity(box_feats)
            delta_scores = transfer_scores(delta_scores, sims["cls"], mc.base_ids,
                                           mc.novel_ids)
            proposal_deltas = transfer_deltas(proposal_deltas, sims["bbox"], mc.base_ids,
                                              mc.novel_ids, mc.num_classes)
        scores = combine_cls_logits(delta_scores, weak_scores)
        bbox = proposal_deltas + weak_box_deltas
        probs = torch.softmax(scores, dim=-1).reshape(b, p, -1)
        return probs, bbox.reshape(b, p, -1), proposals, feats

    def predict(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Detections:
        """Batched inference -> Detections [B, D] in canvas coordinates."""
        mc = self.mc
        probs, bbox, proposals, _ = self.predict_raw(images, image_sizes)
        dets = [
            frcnn.fast_rcnn_inference_single(
                probs[i], bbox[i], proposals.boxes[i], proposals.valid[i],
                (image_sizes[i, 0], image_sizes[i, 1]), mc.frcnn, nms_impl=mc.nms_impl,
            )
            for i in range(probs.shape[0])
        ]
        return stack_fields(dets, Detections)
