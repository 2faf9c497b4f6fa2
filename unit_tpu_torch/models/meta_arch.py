"""The weakly-supervised R-CNN detector: base training and serving.

Port of unit_tpu/models/meta_arch.py:43-336,346-361,429-876 for the
``WeaklySupervisedRCNNNoMeta``, ``WeaklySupervisedRCNN`` (the meta recipe),
``WeakRCNN`` and ``WeaklySupervisedRCNNRPN`` meta-architectures.
Inference: ResNet-C4 (or InceptionResNetV2, the note recipe's) -> RPN (+ NMS
kernel K3) -> ROIAlignV2 (K1) -> one or two Res5 heads (or the
InceptionResNetV2 tail) -> supervised delta heads + OICR weak detector ->
lingual/visual base->novel transfer -> softmax -> per-class NMS (K3).  The
dock recipe (VGG-CNN-F, or VGG16) pools with ROIPool (plain torch, as XLA in
unit_tpu) into the VGG fc heads, and under MODEL.LOAD_PROPOSALS takes
precomputed (MCG) proposals from the batch in place of the RPN: for the
strong stream (no RPN losses), the weak stream and predict; a stream whose
batch holds none falls back to the RPN.
Training (``train_losses``): one fused backbone + RPN pass over both
streams, RPN losses, proposal sampling, ROIAlignV2 with its
backward (K1 + K2), supervised Fast R-CNN losses on top of the frozen weak
scores, MIL + OICR losses on the weak stream.  Fine-tuning
(``*FineTune`` supervised heads, ``WeakDetectorOutputsFT``) adds the
zero-initialised residual heads and applies the base->novel transfer in
training too.  Under MODEL.MASK_ON (``Res5BoxHeadWithMask``) the box head keeps
its 4-D map in training, the predictors take its spatial mean, and the mask
head learns on the foreground slots (``loss_mask``, through the mask
transfer when fine-tuning); ``predict`` runs ROIAlignV2 (K1), Res5 and the
mask head again over the final detections.  WEAK_DETECTOR.TYPE PCL
replaces the OICR losses by PCL's (models/pcl.py).  ``train_only_weak``
(TrainerOnlyWeak) trains the RPN on the strong batch and the weak branch on
the weak one, nothing else.  ``WeakRCNN`` serves with the weak detector alone
(``predict_weak_only``); ``WeaklySupervisedRCNNRPN`` adds RPN losses on the
weak images against the weak detector's own confident detections
(``rpn_self_training_losses``).  Under the meta ROI heads (``WSROIHead``,
``WSROIHeadFineTuneMeta``) the model holds a visual attention head
(models/visual_attention.py): ``compute_meta_attention`` turns a support
batch into class prototypes through a backbone pass without gradient and K1
over the shots, and ``train_losses(meta=...)`` adds the rank losses over the
first ``rank_loss_slots`` sampled slots of each strong image.  The attention
does not feed inference, as in unit_tpu.  Pipeline parallelism splits the
step at ``backbone_features`` / ``backbone_segment`` (a range of ResNet-C4
units) and ``train_losses(backbone_feats=...)`` (the rest, from a map the
stage before handed over).  ``predict_tta`` is the multi-scale +
flip test-time augmentation: proposals from the canonical image (or
precomputed ones in its frame), each scale's flip pair scored in one batch-2
pass.  The VGG heads' dropout runs only when the train step passes a
dropout generator.  Every backbone carries every box head, the visual
attention head and the mask head, each built over the backbone's width, as
unit_tpu's flax modules infer theirs; masks over a VGG fc head, which keeps
no map, raise a ``ValueError``, where unit_tpu fails too.  The attention
head pools its support shots with ROIAlignV2 (K1) whatever the box pooler is
(the dock's ROIPool model too), and its rank losses read the box pooler's
maps of the sampled slots; the mask head reads the box head's map before its
spatial mean (InceptionResNetHead's [N, 8, 8, 1536] at P = 17: 16 x 16
masks).

Precision mirrors ``TPU.COMPUTE_DTYPE``: backbone, RPN convs and box heads run in
the compute dtype; RPN outputs, box features and all predictor, transfer and
softmax math are f32; pooled features keep the feature dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import validate_registry_names
from ..ops import roi_align as roi_align_ops
from ..ops import sampling as sampling_ops
from ..parallel import spatial
from ..structures.instances import (
    Detections,
    GTInstances,
    Proposals,
    SampledProposals,
    stack_fields,
)
from . import fast_rcnn as frcnn
from . import mask_head as mask_lib
from . import pcl as pcl_lib
from . import rpn as rpn_lib
from . import similarity as sim_lib
from . import weak_losses as weak_lib
from .predictors import (
    SupervisedPredictor,
    WeakDetectorPredictor,
    combine_cls_logits,
    transfer_deltas,
    transfer_scores,
)
from ..ops.roi_pool import roi_pool_max
from .backbones import BACKBONE_REGISTRY, build_backbone
from .box_heads import BOX_HEAD_REGISTRY, VGG_HEADS, build_box_head
from .resnet import ResNetC4, set_bn_act_impl
from .visual_attention import MetaAttention, VisualAttentionHead

# TPU.ROI_ALIGN_IMPL / TPU.NMS_IMPL keep their meaning: the hand-written CUDA
# kernel takes the Pallas kernel's place, the plain PyTorch version XLA's.
_IMPLS = {"auto": "auto", "pallas": "cuda", "xla": "plain"}


# MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME -> VisualAttentionHead mode
_ATTENTION_MODES = {
    "MahalanobisSimilarity": "mahalanobis",
    "MeanSimilarity": "mean",
    "MeanMatrixSimilarity": "matrix",
    "MeanMatrixSimilarityLocatron": "locatron",
}


# MODEL.BACKBONE.NAME -> the RPN conv's width (unit_tpu meta_arch.py:125-133)
_RPN_CONV_DIM = {
    "build_resnet_backbone": 1024,
    "build_vgg_backbone": 512,
    "VGG": 512,
    "build_vgg_cnn_f_backbone": 256,
    "VGG_CNN_F": 256,
    "build_inception_resnet_v2_backbone": 1088,
    "InceptionResNetV2": 1088,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model configuration distilled from the CfgNode (predict path)."""

    meta_architecture: str = "WeaklySupervisedRCNNNoMeta"
    backbone_name: str = "build_resnet_backbone"
    backbone_dilated: bool = False  # VGG16's MODEL.BACKBONE.DILATED
    box_head_name: str = "Res5BoxHead"
    rpn_conv_dim: int = 1024  # the RPN's 3x3 conv width: the backbone's channels
    depth: int = 50
    res2_out_channels: int = 256
    num_classes: int = 20
    base_ids: Tuple[int, ...] = ()
    novel_ids: Tuple[int, ...] = ()
    multi_box_head: bool = False
    pooler_resolution: int = 14
    pooler_scale: float = 1.0 / 16.0
    pooler_type: str = "ROIAlignV2"  # ROIAlignV2 | ROIAlign (unaligned) | ROIPool
    sampling_ratio: int = 2
    roi_batch_size: int = 512
    roi_positive_fraction: float = 0.25
    roi_iou_thresholds: Tuple[float, ...] = (0.5,)
    roi_iou_labels: Tuple[int, ...] = (0, 1)
    proposal_append_gt: bool = True
    weak_proposal_count: int = 512
    detector_temp: float = 1.0
    classifier_temp: float = 1.0
    regression_branch: bool = False
    oicr_regression_branch: bool = False
    oicr_iter: int = 3
    weak_detector_type: str = "OICR"  # OICR | PCL
    num_kmeans_cluster: int = 3
    graph_iou_threshold: float = 0.4
    max_pc_num: int = 5
    rpn_self_training: bool = False   # WeaklySupervisedRCNNRPN
    weak_rpn_score_threshold: float = 0.99
    finetune: bool = False              # *_ft residual heads + train-time transfer
    weak_finetune_detach: bool = False  # SupervisedDetectorOutputsWeakFineTune
    weak_detector_finetune: bool = False  # WeakDetectorOutputsFT delta streams
    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    normalize_images: bool = False
    compute_dtype: str = "float32"
    remat_backbone: bool = False  # TPU.REMAT_BACKBONE: recompute the backbone in backward
    roi_align_impl: str = "auto"  # auto | cuda | plain
    nms_impl: str = "auto"        # auto | cuda | plain
    bn_act_impl: str = "auto"     # auto | cuda | plain (no YAML key: auto)
    mask_on: bool = False
    mask_head_finetune: bool = False  # MaskRCNNConvUpsampleHeadWithFineTune
    mask_num_conv: int = 0
    mask_fg_slots: int = 128  # foreground capacity of the mask loss (= S * pos_frac)
    load_proposals: bool = False
    use_meta: bool = False            # WSROIHead: the support stream and rank losses
    attention_mode: str = "mean"      # VISUAL_ATTENTION_HEAD.NAME -> visual_attention.MODES
    rank_loss_slots: int = 100        # sampled slots of a strong image in the rank losses
    rpn: rpn_lib.RPNConfig = rpn_lib.RPNConfig()
    frcnn: frcnn.FastRCNNConfig = frcnn.FastRCNNConfig(num_classes=20)
    weak: weak_lib.WeakLossConfig = weak_lib.WeakLossConfig(num_classes=20)
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
        roi = cfg.MODEL.ROI_HEADS
        wd = roi.FAST_RCNN.WEAK_DETECTOR
        fast_name = cfg.MODEL.ROI_HEADS.FAST_RCNN.NAME
        return cls(
            meta_architecture=cfg.MODEL.META_ARCHITECTURE,
            backbone_name=cfg.MODEL.BACKBONE.NAME,
            backbone_dilated=cfg.MODEL.BACKBONE.DILATED,
            box_head_name=cfg.MODEL.ROI_BOX_HEAD.NAME,
            rpn_conv_dim=_RPN_CONV_DIM.get(cfg.MODEL.BACKBONE.NAME, 1024),
            depth=cfg.MODEL.RESNETS.DEPTH,
            res2_out_channels=cfg.MODEL.RESNETS.RES2_OUT_CHANNELS,
            num_classes=num_classes,
            base_ids=tuple(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID),
            novel_ids=tuple(cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID),
            multi_box_head=cfg.MODEL.ROI_HEADS.MULTI_BOX_HEAD,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            pooler_type=cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE,
            sampling_ratio=cfg.TPU.ROI_ALIGN_SAMPLING_RATIO,
            roi_batch_size=roi.BATCH_SIZE_PER_IMAGE,
            roi_positive_fraction=roi.POSITIVE_FRACTION,
            roi_iou_thresholds=tuple(roi.IOU_THRESHOLDS),
            roi_iou_labels=tuple(roi.IOU_LABELS),
            proposal_append_gt=roi.PROPOSAL_APPEND_GT,
            weak_proposal_count=(roi.BATCH_SIZE_PER_IMAGE
                                 // roi.WEAK_CLASSIFIER_PROPOSAL_DIVISOR),
            detector_temp=wd.DETECTOR_TEMP,
            classifier_temp=wd.CLASSIFIER_TEMP,
            regression_branch=wd.REGRESSION_BRANCH,
            oicr_regression_branch=wd.OICR_REGRESSION_BRANCH,
            oicr_iter=wd.OICR_ITER,
            weak_detector_type=wd.TYPE,
            num_kmeans_cluster=wd.NUM_KMEANS_CLUSTER,
            graph_iou_threshold=wd.GRAPH_IOU_THRESHOLD,
            max_pc_num=wd.MAX_PC_NUM,
            rpn_self_training=cfg.MODEL.META_ARCHITECTURE == "WeaklySupervisedRCNNRPN",
            weak_rpn_score_threshold=cfg.MODEL.PROPOSAL_GENERATOR.WEAK_RPN_SCORE_TRESHOLD,
            finetune="FineTune" in fast_name and "Weak" not in fast_name,
            weak_finetune_detach=fast_name == "SupervisedDetectorOutputsWeakFineTune",
            weak_detector_finetune=wd.NAME == "WeakDetectorOutputsFT",
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            normalize_images=cfg.INPUT.NORMALIZE_IMAGES,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            remat_backbone=cfg.TPU.REMAT_BACKBONE,
            roi_align_impl=_IMPLS.get(cfg.TPU.ROI_ALIGN_IMPL, cfg.TPU.ROI_ALIGN_IMPL),
            nms_impl=_IMPLS.get(cfg.TPU.NMS_IMPL, cfg.TPU.NMS_IMPL),
            mask_on=cfg.MODEL.MASK_ON,
            mask_head_finetune="FineTune" in cfg.MODEL.ROI_MASK_HEAD.NAME,
            mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
            mask_fg_slots=int(roi.BATCH_SIZE_PER_IMAGE * roi.POSITIVE_FRACTION),
            load_proposals=cfg.MODEL.LOAD_PROPOSALS,
            use_meta=cfg.MODEL.ROI_HEADS.NAME in ("WSROIHead", "WSROIHeadFineTuneMeta"),
            attention_mode=_ATTENTION_MODES.get(roi.VISUAL_ATTENTION_HEAD.NAME, "mean"),
            rpn=rpn_lib.RPNConfig.from_cfg(cfg),
            frcnn=frcnn.FastRCNNConfig.from_cfg(cfg),
            weak=weak_lib.WeakLossConfig(
                num_classes=num_classes,
                oicr_iter=wd.OICR_ITER,
                fg_threshold=roi.IOU_THRESHOLDS[0],
                bg_threshold=wd.BG_THRESHOLD,
                mil_multiplier=wd.MIL_MULTIPLIER,
                weak_loss_multiplier=wd.WEAK_LOSS_MULTIPLIER,
                bbox_reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
                smooth_l1_beta=cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA,
                regression_branch=wd.REGRESSION_BRANCH,
                oicr_regression_branch=wd.OICR_REGRESSION_BRANCH,
            ),
            sim=sim_lib.SimilarityConfig.from_cfg(cfg, class_names),
        )


def _check_supported(mc: ModelConfig) -> None:
    if mc.backbone_name not in BACKBONE_REGISTRY:
        raise ValueError(f"unknown backbone {mc.backbone_name!r}")
    if mc.box_head_name not in BOX_HEAD_REGISTRY:
        raise ValueError(f"unknown box head {mc.box_head_name!r}")
    # every backbone carries every box head, the visual attention head's Res5
    # and the mask head, as in unit_tpu, whose flax modules infer their input
    # widths; the port builds each over the backbone's channels.  The one
    # pairing refused: the mask head over a VGG fc head, which flattens each
    # ROI and keeps no map to upsample (unit_tpu's mask head asserts a 4-D
    # input there)
    if mc.mask_on and mc.box_head_name in VGG_HEADS:
        raise ValueError(f"MODEL.MASK_ON needs a box head with a spatial map; "
                         f"{mc.box_head_name!r} has none (fc6 flattens each ROI)")
    if mc.pooler_type not in ("ROIAlignV2", "ROIAlign", "ROIPool"):
        raise ValueError(f"unknown pooler {mc.pooler_type!r} (ROIAlignV2 | ROIAlign | ROIPool)")
    for impl in (mc.roi_align_impl, mc.nms_impl, mc.bn_act_impl):
        if impl not in ("auto", "cuda", "plain"):
            raise ValueError(f"unknown kernel impl {impl!r} (auto | cuda | plain)")


class WSRCNN(nn.Module):
    """All parametric components of the detector, named after the flax tree.

    ``generator`` seeds the port's own initialisation, which follows flax's
    initialisers: lecun_normal convs, normal(0.01) RPN convs, the predictors'
    normal/zero Dense inits, identity FrozenBN, normal(0.02) embeddings (the
    GloVe table replaces them: checkpoint.embeddings), and under MODEL.MASK_ON
    the mask head's (mask_head.MaskRCNNConvUpsampleHead).
    """

    def __init__(self, mc: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(mc)
        self.mc = mc
        g, dt = generator, mc.dtype
        self.backbone = build_backbone(mc.backbone_name, depth=mc.depth,
                                       res2_out_channels=mc.res2_out_channels,
                                       dilated=mc.backbone_dilated, dtype=dt, generator=g)
        c = self.backbone.out_channels
        self.rpn_head = rpn_lib.RPNHead(c, mc.rpn.num_cell_anchors, conv_dim=mc.rpn_conv_dim,
                                        dtype=dt, generator=g)

        def box_head():
            return build_box_head(mc.box_head_name, c, depth=mc.depth,
                                  res2_out_channels=mc.res2_out_channels,
                                  pooler_resolution=mc.pooler_resolution, dtype=dt,
                                  generator=g)

        self.box_head = box_head()
        if mc.multi_box_head:
            self.weak_box_head = box_head()
        d = self.box_head.out_channels
        self.supervised = SupervisedPredictor(d, mc.num_classes, finetune=mc.finetune,
                                              regression_branch=mc.regression_branch,
                                              generator=g)
        self.weak_detector = WeakDetectorPredictor(
            d, mc.num_classes, oicr_iter=mc.oicr_iter, detector_temp=mc.detector_temp,
            classifier_temp=mc.classifier_temp, finetune=mc.weak_detector_finetune,
            novel_ids=mc.novel_ids, regression_branch=mc.regression_branch,
            oicr_regression_branch=mc.oicr_regression_branch, generator=g)
        emb = torch.empty(80, 300)
        with torch.no_grad():
            emb.normal_(0.0, 0.02, generator=g)
        self.register_buffer("embeddings", emb)
        if mc.mask_on:
            self.mask_head = mask_lib.MaskRCNNConvUpsampleHead(
                d, mc.num_classes, num_conv=mc.mask_num_conv,
                finetune=mc.mask_head_finetune, dtype=dt, generator=g)
        if mc.use_meta:
            self.visual_attention = VisualAttentionHead(
                mc.num_classes, depth=mc.depth, res2_out_channels=mc.res2_out_channels,
                in_channels=c, mode=mc.attention_mode, pooler_resolution=mc.pooler_resolution,
                pooler_scale=mc.pooler_scale, sampling_ratio=mc.sampling_ratio,
                roi_align_impl=mc.roi_align_impl, dtype=dt, generator=g)
        set_bn_act_impl(self, mc.bn_act_impl)

    # ---------------------------------------------------------------- pieces
    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """Optional /255, then caffe-style BGR mean/std, in f32 (uint8 images
        of the uint8 wire are cast here, on the device)."""
        x = images.to(torch.float32)
        if self.mc.normalize_images:
            x = x / 255.0
        mean = torch.tensor(self.mc.pixel_mean, device=x.device)
        std = torch.tensor(self.mc.pixel_std, device=x.device)
        return (x - mean) / std

    def _run_backbone(self, fn, x: torch.Tensor, remat: Optional[bool], *args) -> torch.Tensor:
        """``fn(x, *args)``, the backbone or a part of it on the preprocessed
        ``x``, under ``torch.utils.checkpoint`` where ``remat`` (None:
        TPU.REMAT_BACKBONE) asks for it and a gradient is taken: it keeps its
        input alone and runs again in backward (unit_tpu's
        ``jax.checkpoint``).  Exact: the backbone draws nothing random and
        FrozenBN is constant."""
        if (self.mc.remat_backbone if remat is None else remat) and torch.is_grad_enabled():
            return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(x, *args)

    def features(self, images: torch.Tensor, remat: Optional[bool] = None) -> torch.Tensor:
        """images [B, H, W, 3] -> stride-16 features [B, h, w, C] (a
        contiguous view of the channels_last backbone output): ResNet-C4's
        res4, h = ceil(H / 16); InceptionResNetV2's block17, smaller (its
        unpadded stem), while the pooler's scale stays 1/16 as in unit_tpu.
        Anchors are laid on the map as it comes.  Inside a 2-D step
        (``parallel.spatial.banded``) ``images`` is this rank's band of the
        canvas rows: the backbone (any of the four) runs on the band,
        exchanging halo rows with the neighbouring bands, and the map is
        gathered whole.  ``remat``:
        ``_run_backbone``; the preprocess stays outside the recompute."""
        x = self.preprocess(images)
        bands = spatial.active()
        if bands is None:
            return self._run_backbone(self.backbone, x, remat).permute(0, 2, 3, 1)
        run = functools.partial(spatial.backbone_bands, self.backbone, bands=bands)
        y, rows = self._run_backbone(run, x, remat)
        return spatial.gather_rows(y.permute(0, 2, 3, 1), bands, rows)

    def rpn(self, feats: torch.Tensor):
        return self.rpn_head(feats)

    def pooled_rois(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """feats [B, h, w, C], boxes [B, S, 4] -> [B*S, P, P, C] (feature
        dtype): ROIAlignV2 (K1, K2 backward), the legacy unaligned ROIAlign
        (plain PyTorch, as unit_tpu's XLA path) or ROIPool."""
        mc = self.mc
        if mc.pooler_type == "ROIPool":
            out = roi_pool_max(feats, boxes, mc.pooler_resolution, mc.pooler_scale)
        else:
            out = roi_align_ops.roi_align_batched(
                feats, boxes.contiguous(), mc.pooler_resolution, mc.pooler_scale,
                mc.sampling_ratio, impl=mc.roi_align_impl,
                aligned=mc.pooler_type == "ROIAlignV2",
            )
        return out.reshape((-1,) + out.shape[2:])

    def box_features(self, pooled: torch.Tensor, head: str = "box",
                     dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The box (or the weak) head's f32 features of pooled ROIs; a VGG
        head drops units when given ``dropout_generator`` (training)."""
        module = self.box_head if head == "box" else self.weak_box_head
        if dropout_generator is None:
            return module(pooled).to(torch.float32)
        return module(pooled, dropout_generator=dropout_generator).to(torch.float32)

    def oicr_weight_mean(self) -> torch.Tensor:
        """Mean OICR classifier weight [C+1, D]."""
        return torch.stack([m.weight for m in self.weak_detector.oicr_predictors()]).mean(0)

    # ---------------------------------------------------------------- training
    def compute_meta_attention(self, support: Dict[str, torch.Tensor]) -> MetaAttention:
        """Support batch -> class prototypes (unit_tpu meta_arch.py:346-361).

        support: {image [C, K, h, w, 3], boxes [C, K, 4], class_valid [C]}.
        The backbone pass over the C * K shots runs without autograd (the
        reference wraps it in torch.no_grad()); the meta box head after the
        pooler keeps its graph, which the prototype classification loss
        trains."""
        image = support["image"]
        c, k = image.shape[:2]
        with torch.no_grad(), spatial.banded(None):  # the shots are whole under a 2-D step
            feats = self.features(image.reshape((c * k,) + image.shape[2:]))
        return self.visual_attention.support_prototypes(
            feats.reshape((c, k) + feats.shape[1:]), support["boxes"], support["class_valid"],
            self.mc.base_ids)

    # ------------------------------------------------- pipeline stages
    @staticmethod
    def _stage_images(strong, weak, what: str) -> torch.Tensor:
        """The first stage's image batch: cat(strong, weak) on their shared
        canvas (the fused pass of ``train_losses``), or the one stream's."""
        if strong is not None and weak is not None:
            if strong["image"].shape[1:] != weak["image"].shape[1:]:
                raise ValueError(f"{what} requires a shared strong/weak canvas, got "
                                 f"{tuple(strong['image'].shape)} vs "
                                 f"{tuple(weak['image'].shape)}")
            return torch.cat([strong["image"], weak["image"]])
        return (strong if strong is not None else weak)["image"]

    def backbone_features(self, strong: Optional[Dict[str, torch.Tensor]] = None,
                          weak: Optional[Dict[str, torch.Tensor]] = None,
                          remat: Optional[bool] = None) -> torch.Tensor:
        """The backbone pass ``train_losses`` would run, [B, h, w, C] (unit_tpu
        meta_arch.py:364-384): the first stage of a two-stage pipeline, for
        every backbone family.  ``remat``: ``_run_backbone``."""
        return self.features(self._stage_images(strong, weak, "backbone_features"), remat)

    def backbone_segment(self, strong: Optional[Dict[str, torch.Tensor]] = None,
                         weak: Optional[Dict[str, torch.Tensor]] = None,
                         feats: Optional[torch.Tensor] = None, start_unit: int = 0,
                         stop_unit: Optional[int] = None,
                         remat: Optional[bool] = None) -> torch.Tensor:
        """ResNet-C4 units ``[start_unit, stop_unit)`` (``resnet.num_units``),
        [B, h, w, C] out (unit_tpu meta_arch.py:386-427): from unit 0 the
        preprocessed image batch of ``backbone_features``, later ``feats``,
        the [B, h, w, C] map of the range before.  ``remat``: ``_run_backbone``."""
        if not isinstance(self.backbone, ResNetC4):
            raise ValueError("backbone_segment (N-stage pipeline parallelism) requires a "
                             f"ResNet-C4 backbone, got {type(self.backbone).__name__}")
        if start_unit == 0:
            x = self.preprocess(self._stage_images(strong, weak, "backbone_segment"))
        elif feats is None:
            raise ValueError("segments past the stem need `feats`")
        else:
            x = feats.permute(0, 3, 1, 2)  # NCHW, channels_last memory
        return self._run_backbone(self.backbone, x, remat, start_unit,
                                  stop_unit).permute(0, 2, 3, 1)

    def _train_proposals(self, feats, logits, deltas, image_sizes) -> Proposals:
        """Training-time proposals (no gradient) of the images behind ``feats``."""
        anchors = rpn_lib.get_anchors(feats.shape[1], feats.shape[2], self.mc.rpn,
                                      device=feats.device)
        return rpn_lib.select_proposals(
            logits.detach(), deltas.detach(), anchors, image_sizes, self.mc.rpn,
            nms_impl=self.mc.nms_impl, training=True)

    def train_losses(
        self,
        generator: Optional[torch.Generator],
        strong: Optional[Dict[str, torch.Tensor]],
        weak: Optional[Dict[str, torch.Tensor]],
        train_only_weak: bool = False,
        meta: Optional[Dict[str, torch.Tensor]] = None,
        dropout_generator: Optional[torch.Generator] = None,
        backbone_feats: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """One training step's loss dict (unit_tpu meta_arch.py:429-651).

        strong: {image [B,H,W,3], gt_boxes [B,G,4], gt_classes [B,G],
                 gt_valid [B,G], image_size [B,2], under MODEL.MASK_ON
                 gt_masks [B,G,M,M], and under MODEL.LOAD_PROPOSALS
                 optionally proposals [B,P,4] and proposals_valid [B,P]:
                 then they are the stream's proposals and the RPN neither
                 proposes nor trains on it}
        weak:   {image [Bw,H',W',3], labels [Bw,C], image_size [Bw,2],
                 optionally labels_host: a CPU copy of labels, from which the
                 PCL losses read the classes present without waiting for the
                 device, and under MODEL.LOAD_PROPOSALS optionally
                 proposals / proposals_valid, of which the stream takes the
                 first ``weak_proposal_count``}
        ``generator`` (on the batches' device) draws every random choice:
        the RPN's anchor subsampling and the ROI heads' proposal sampling.
        With ``train_only_weak`` (TrainerOnlyWeak) the strong batch trains
        the RPN alone: no proposals, sampling or supervised heads for it.
        meta:   {image [C,K,h,w,3], boxes [C,K,4], class_valid [C]}, the
                support batch of a meta model (``Trainer``): it adds the rank
                losses of the first ``rank_loss_slots`` sampled slots of each
                strong image against the batch's prototypes; ignored by a
                model without the meta ROI heads, as in unit_tpu.
        dropout_generator: the VGG heads' dropout draws (the train step
                passes one for them alone); None, no dropout.
        backbone_feats: the [B, h, w, C] map ``backbone_features(strong,
                weak)`` would give (a pipeline's hand-off): the backbone is
                not run.  Both streams must then share one canvas.
        """
        mc = self.mc
        losses: Dict[str, torch.Tensor] = {}
        strong_pre = mc.load_proposals and strong is not None and "proposals" in strong
        weak_pre = mc.load_proposals and weak is not None and "proposals" in weak
        rpn_s = strong is not None and not strong_pre
        rpn_w = weak is not None and (not weak_pre or mc.rpn_self_training)

        # Both streams on one canvas: one fused backbone + RPN pass over
        # cat(strong, weak), and one proposal selection (one launch of K3) for
        # all images that need proposals; the gradients are those of two
        # passes, and the proposals those of one selection a stream (images
        # are independent).  Precomputed proposals take a stream out of the
        # RPN.
        feats = feats_w = logits = deltas = logits_w = deltas_w = proposals = props_w = None
        both = strong is not None and weak is not None
        fused = both and strong["image"].shape[1:] == weak["image"].shape[1:]
        if backbone_feats is not None and both and not fused:
            raise ValueError("backbone_feats requires a shared strong/weak canvas "
                             "(the fused backbone pass)")
        if fused:
            bs = strong["image"].shape[0]
            all_feats = (backbone_feats if backbone_feats is not None
                         else self.features(torch.cat([strong["image"], weak["image"]])))
            feats, feats_w = all_feats[:bs], all_feats[bs:]
            if rpn_s and rpn_w:
                all_logits, all_deltas = self.rpn(all_feats)
                logits, logits_w = all_logits[:bs], all_logits[bs:]
                deltas, deltas_w = all_deltas[:bs], all_deltas[bs:]
                if not train_only_weak and not weak_pre:
                    both = self._train_proposals(
                        all_feats, all_logits, all_deltas,
                        torch.cat([strong["image_size"], weak["image_size"]]))
                    proposals, props_w = (
                        Proposals(**{f.name: getattr(both, f.name)[part]
                                     for f in dataclasses.fields(Proposals)})
                        for part in (slice(0, bs), slice(bs, None)))
            elif rpn_s:
                logits, deltas = self.rpn(feats)
            elif rpn_w:
                logits_w, deltas_w = self.rpn(feats_w)

        if strong is not None:
            gt = GTInstances(boxes=strong["gt_boxes"], classes=strong["gt_classes"].long(),
                             valid=strong["gt_valid"].bool())
            if feats is None:
                feats = (backbone_feats if backbone_feats is not None
                         else self.features(strong["image"]))
        if rpn_s:
            if logits is None:
                logits, deltas = self.rpn(feats)
            # the RPN trains on the strong batch under train_only_weak too
            anchors = rpn_lib.get_anchors(feats.shape[1], feats.shape[2], mc.rpn,
                                          device=feats.device)
            losses.update(rpn_lib.rpn_losses(generator, logits, deltas, anchors, gt, mc.rpn))
        if strong is not None and not train_only_weak:
            if strong_pre:
                proposals = self._given_proposals(strong["proposals"],
                                                  strong["proposals_valid"])
            elif proposals is None:
                proposals = self._train_proposals(feats, logits, deltas, strong["image_size"])
            sampled = stack_fields([
                sampling_ops.label_and_sample_proposals(
                    generator, proposals.boxes[i], proposals.valid[i],
                    GTInstances(gt.boxes[i], gt.classes[i], gt.valid[i]),
                    mc.roi_batch_size, mc.roi_positive_fraction, mc.num_classes,
                    mc.roi_iou_thresholds, mc.roi_iou_labels, mc.proposal_append_gt)
                for i in range(feats.shape[0])
            ], SampledProposals)

            pooled = self.pooled_rois(feats, sampled.boxes)
            if mc.mask_on:
                # Res5BoxHeadWithMask keeps the 4-D map for the mask head;
                # the predictors take its spatial mean
                feats4d = self.box_head(pooled, spatial_mean=False)
                box_feats = feats4d.mean(dim=(1, 2)).to(torch.float32)
            else:
                box_feats = self.box_features(pooled, "box", dropout_generator)
            sup = self.supervised(box_feats)
            # Frozen weak scores on top of the deltas: no graph (unit_tpu
            # stops the gradient here), so Res5 keeps no activations for it.
            with torch.no_grad():
                sup_weak_feats = (self.box_features(pooled, "weak", dropout_generator)
                                  if mc.multi_box_head else box_feats)
                weak_scores, weak_box_deltas = self.weak_detector.evaluation(sup_weak_feats)
            delta_scores, proposal_deltas = sup["delta_scores"], sup["proposal_deltas"]
            sims = None
            if mc.finetune or mc.weak_finetune_detach:
                # fine-tuning applies the transfer in training too, from the
                # box head's features (unit_tpu meta_arch.py:556-568)
                sims = self.inference_similarity(box_feats)
                delta_scores, proposal_deltas = self._transfer(
                    delta_scores, proposal_deltas, sims, detach=mc.weak_finetune_detach)
            scores = combine_cls_logits(delta_scores, weak_scores)
            bbox = proposal_deltas + weak_box_deltas
            if mc.finetune:
                scores = scores + sup["ft_scores"]
                bbox = bbox + sup["ft_deltas"]
            elif not mc.weak_finetune_detach:
                scores = frcnn.mask_novel_scores(scores, mc.novel_ids)
            flat = SampledProposals(**{
                f.name: getattr(sampled, f.name).flatten(0, 1)
                for f in dataclasses.fields(SampledProposals)})
            losses.update(frcnn.fast_rcnn_losses(scores, bbox, flat, mc.frcnn))
            if mc.mask_on and "gt_masks" in strong:
                losses["loss_mask"] = self._mask_loss(feats4d, sampled, strong["gt_masks"], sims)
            if mc.use_meta and meta is not None:
                # the rank losses over the first slots the sampler emitted
                # (fewer than roi_batch_size on a small RPN top-k); they read
                # the strong stream's pooled maps detached: no K1 of their own
                b, n_slots = sampled.boxes.shape[:2]
                ks = min(mc.rank_loss_slots, n_slots)
                losses.update(self.visual_attention.rank_loss(
                    pooled.unflatten(0, (b, n_slots))[:, :ks].flatten(0, 1),
                    sampled.gt_classes[:, :ks].flatten(), sampled.valid[:, :ks].flatten(),
                    self.compute_meta_attention(meta), mc.base_ids))

        if weak is not None:
            if feats_w is None:
                feats_w = (backbone_feats if backbone_feats is not None
                           else self.features(weak["image"]))
            if rpn_w and logits_w is None:
                logits_w, deltas_w = self.rpn(feats_w)
            if weak_pre:
                props_w = self._given_proposals(weak["proposals"], weak["proposals_valid"])
            elif props_w is None:
                props_w = self._train_proposals(feats_w, logits_w, deltas_w, weak["image_size"])
            # the top (BATCH_SIZE_PER_IMAGE // WEAK_CLASSIFIER_PROPOSAL_DIVISOR)
            w_boxes = props_w.boxes[:, :mc.weak_proposal_count].contiguous()
            w_valid = props_w.valid[:, :mc.weak_proposal_count]
            pooled_w = self.pooled_rois(feats_w, w_boxes)
            weak_feats = self.box_features(pooled_w, "weak" if mc.multi_box_head else "box",
                                           dropout_generator)
            streams = self.weak_detector(weak_feats)
            if mc.weak_detector_type == "PCL":
                present = pcl_lib.present_classes(weak.get("labels_host", weak["labels"]))
                losses.update(pcl_lib.pcl_detector_losses(
                    streams, w_boxes, w_valid, weak["labels"], mc.weak, present,
                    mc.num_kmeans_cluster, mc.graph_iou_threshold, mc.max_pc_num))
            else:
                losses.update(weak_lib.weak_detector_losses(
                    streams, w_boxes, w_valid, weak["labels"], mc.weak))
            if mc.rpn_self_training:
                losses.update(self.rpn_self_training_losses(weak, feats_w, logits_w, deltas_w))
        return losses

    def rpn_self_training_losses(self, weak: Dict[str, torch.Tensor], feats_w=None,
                                 logits_w=None, deltas_w=None) -> Dict[str, torch.Tensor]:
        """WeaklySupervisedRCNNRPN: the weak detector's detections on the weak
        images scoring above WEAK_RPN_SCORE_TRESHOLD, of classes present in
        their labels, are the RPN's pseudo-GT there; the RPN losses against
        them, keys suffixed ``_weak``, with a fixed generator seeded 0 (unit_tpu
        uses PRNGKey(0)).

        ``feats_w``, ``logits_w``, ``deltas_w``: the weak images' features and
        RPN outputs of the training pass, reused (unit_tpu runs the backbone
        on them twice more: the same values, so the same losses; the gradient
        differs only in summation order).  The detections are made without
        autograd from detached features."""
        mc = self.mc
        if feats_w is None:
            feats_w = self.features(weak["image"])
        if logits_w is None:
            logits_w, deltas_w = self.rpn(feats_w)
        with torch.no_grad():
            dets = self._predict_weak_only(feats_w.detach(), logits_w.detach(),
                                           deltas_w.detach(), weak["image_size"])
        in_image = weak["labels"].gather(1, dets.classes) > 0.5
        keep = dets.valid & in_image & (dets.scores > mc.weak_rpn_score_threshold)
        pseudo = GTInstances(boxes=dets.boxes, classes=dets.classes, valid=keep)
        anchors = rpn_lib.get_anchors(feats_w.shape[1], feats_w.shape[2], mc.rpn,
                                      device=feats_w.device)
        generator = torch.Generator(device=logits_w.device)
        generator.manual_seed(0)
        losses = rpn_lib.rpn_losses(generator, logits_w, deltas_w, anchors, pseudo, mc.rpn)
        return {f"{k}_weak": v for k, v in losses.items()}

    @staticmethod
    def _given_proposals(boxes: torch.Tensor, valid: Optional[torch.Tensor] = None
                         ) -> Proposals:
        """Precomputed proposals [B, P, 4] (all valid unless ``valid`` [B, P]
        says otherwise) as a Proposals of zero objectness."""
        shape = boxes.shape[:2]
        return Proposals(
            boxes=boxes.to(torch.float32),
            objectness=torch.zeros(shape, dtype=torch.float32, device=boxes.device),
            valid=(torch.ones(shape, dtype=torch.bool, device=boxes.device) if valid is None
                   else valid.bool()))

    def _mask_loss(self, feats4d, sampled: SampledProposals, gt_masks, sims) -> torch.Tensor:
        """The mask loss over the first ``mask_fg_slots`` slots of each image,
        which hold all its foreground (the sampler puts it first); under
        fine-tuning through the mask transfer (``sims``: the box path's
        similarity matrices), the delta head added after it."""
        mc = self.mc
        b, s = sampled.boxes.shape[:2]
        k = min(mc.mask_fg_slots, s)

        def first_k(x):  # [B * S, ...] -> [B * k, ...]
            return x.unflatten(0, (b, s))[:, :k].flatten(0, 1)

        def slots(x):  # [B, S, ...] -> [B * k, ...]
            return x[:, :k].flatten(0, 1)

        logits, delta = self.mask_head(first_k(feats4d))
        if sims is not None:
            seg = sims["seg"]
            logits = mask_lib.transfer_mask_logits(
                logits, first_k(seg) if seg.dim() > 2 else seg, mc.base_ids, mc.novel_ids)
        if delta is not None:
            logits = logits + delta
        rows = torch.arange(b, device=gt_masks.device).repeat_interleave(k)
        return mask_lib.mask_rcnn_loss(
            logits, slots(sampled.gt_classes), gt_masks[rows, slots(sampled.gt_index)],
            slots(sampled.gt_boxes), slots(sampled.boxes), slots(sampled.is_fg))

    # ---------------------------------------------------------------- inference
    def inference_similarity(self, box_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Similarity matrices for the base->novel transfer; the weak scores
        they read carry no gradient (unit_tpu stops it)."""
        with torch.no_grad():
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

    def _transfer(self, delta_scores, proposal_deltas, sims, detach: bool = False):
        """The base->novel transfer of the supervised scores and deltas by the
        similarity matrices ``sims`` (``inference_similarity``)."""
        mc = self.mc
        return (transfer_scores(delta_scores, sims["cls"], mc.base_ids, mc.novel_ids,
                                detach=detach),
                transfer_deltas(proposal_deltas, sims["bbox"], mc.base_ids, mc.novel_ids,
                                mc.num_classes, detach=detach))

    def _test_proposals(self, feats, logits, deltas, image_sizes) -> Proposals:
        """Test-time proposals (RPN_TEST settings, K3) of the images behind
        ``feats``."""
        anchors = rpn_lib.get_anchors(feats.shape[1], feats.shape[2], self.mc.rpn,
                                      device=feats.device)
        return rpn_lib.select_proposals(logits, deltas, anchors, image_sizes, self.mc.rpn,
                                        nms_impl=self.mc.nms_impl)

    def _score_rois(self, pooled, parts: int = 1, with_transfer: bool = True):
        """Class probabilities [R, C+1] and box deltas [R, C*4] of pooled ROIs
        [R, 14, 14, C]: the box (and under MULTI_BOX_HEAD the weak) Res5 head,
        the supervised and weak predictors, the base->novel transfer, the
        ``*_ft`` terms of a fine-tune model, and the softmax.  The rows are
        ``parts`` equal blocks (TTA variants), and the transfer of each block
        reads the similarity of its own rows (the reference computes it from
        each variant's proposals)."""
        mc = self.mc
        box_feats = self.box_features(pooled, "box")
        sup = self.supervised(box_feats)
        sup_weak_feats = self.box_features(pooled, "weak") if mc.multi_box_head else box_feats
        weak_scores, weak_box_deltas = self.weak_detector.evaluation(sup_weak_feats)

        delta_scores = sup["delta_scores"]
        proposal_deltas = sup["proposal_deltas"]
        if with_transfer and len(mc.novel_ids):
            rows = box_feats.shape[0] // parts
            blocks = [self._transfer(delta_scores[sl], proposal_deltas[sl],
                                     self.inference_similarity(box_feats[sl]))
                      for sl in (slice(i * rows, (i + 1) * rows) for i in range(parts))]
            delta_scores = torch.cat([ds for ds, _ in blocks])
            proposal_deltas = torch.cat([pd for _, pd in blocks])
        scores = combine_cls_logits(delta_scores, weak_scores)
        bbox = proposal_deltas + weak_box_deltas
        if mc.finetune:
            scores = scores + sup["ft_scores"]
            bbox = bbox + sup["ft_deltas"]
        return torch.softmax(scores, dim=-1), bbox

    def predict_raw(self, images: torch.Tensor, image_sizes: torch.Tensor,
                    proposal_boxes: Optional[torch.Tensor] = None,
                    proposal_valid: Optional[torch.Tensor] = None):
        """Everything of :meth:`predict` before the final NMS:
        ``(probs [B,P,C+1], bbox [B,P,C*4], proposals, feats)``; images
        [B, H, W, 3] f32 BGR, image_sizes [B, 2] (h, w) of the content.
        ``proposal_boxes`` [B, P, 4] (with ``proposal_valid`` [B, P], else
        all valid): precomputed proposals in canvas coordinates, and no RPN."""
        feats = self.features(images)
        if proposal_boxes is not None:
            proposals = self._given_proposals(proposal_boxes, proposal_valid)
        else:
            proposals = self._test_proposals(feats, *self.rpn(feats), image_sizes)
        b, p = proposals.boxes.shape[:2]
        probs, bbox = self._score_rois(self.pooled_rois(feats, proposals.boxes))
        return probs.reshape(b, p, -1), bbox.reshape(b, p, -1), proposals, feats

    def predict(self, images: torch.Tensor, image_sizes: torch.Tensor,
                proposal_boxes: Optional[torch.Tensor] = None,
                proposal_valid: Optional[torch.Tensor] = None) -> Detections:
        """Batched inference -> Detections [B, D] in canvas coordinates, with
        their masks under MODEL.MASK_ON; precomputed proposals as in
        :meth:`predict_raw`."""
        probs, bbox, proposals, feats = self.predict_raw(images, image_sizes, proposal_boxes,
                                                         proposal_valid)
        dets = self._final_detections(probs, bbox, proposals, image_sizes)
        if self.mc.mask_on:
            dets.masks = self._predict_masks(feats, dets)
        return dets

    def _final_detections(self, probs, bbox, proposals: Proposals, image_sizes) -> Detections:
        """Per-class NMS of each image's scored proposals -> Detections [B, D]."""
        mc = self.mc
        return stack_fields([
            frcnn.fast_rcnn_inference_single(
                probs[i], bbox[i], proposals.boxes[i], proposals.valid[i],
                (image_sizes[i, 0], image_sizes[i, 1]), mc.frcnn, nms_impl=mc.nms_impl,
            )
            for i in range(probs.shape[0])
        ], Detections)

    def predict_tta_raw(self, canonical_image: torch.Tensor,
                        canonical_image_sizes: torch.Tensor, variants,
                        with_transfer: bool = True, proposal_boxes=None,
                        tta_topk: int = 0, proposal_valid=None):
        """Everything of :meth:`predict_tta` before the final NMS:
        ``(probs [B, P, C+1] summed over the variants, mean deltas [B, P, C*4],
        the canonical proposals)``."""
        if proposal_boxes is not None:
            # no canonical pass: the given boxes are the canonical proposals
            proposals = self._given_proposals(proposal_boxes, proposal_valid)
        else:
            feats0 = self.features(canonical_image)
            proposals = self._test_proposals(feats0, *self.rpn(feats0), canonical_image_sizes)
            del feats0
        if tta_topk and tta_topk < proposals.boxes.shape[1]:
            # TPU.TTA_PROPOSAL_TOPK: the top-K canonical proposals by
            # objectness; a stable sort takes the lower index first among
            # equal scores, as lax.top_k does (invalid slots tie at -inf)
            score = torch.where(proposals.valid, proposals.objectness, -torch.inf)
            idx = torch.sort(score, dim=1, descending=True, stable=True)[1][:, :tta_topk]
            proposals = Proposals(
                boxes=torch.gather(proposals.boxes, 1, idx[..., None].expand(-1, -1, 4)),
                objectness=torch.gather(proposals.objectness, 1, idx),
                valid=torch.gather(proposals.valid, 1, idx))
        b, p = proposals.boxes.shape[:2]
        n_rows = b * p

        # each scale's flip pair shares an image shape: one batch-2 pass of
        # the backbone, K1 and the heads; the group's rows are sliced back
        # apart by variant for the transfer and the flip signs
        groups: Dict[tuple, list] = {}
        for vi, var in enumerate(variants):
            groups.setdefault(tuple(var["image"].shape), []).append(vi)
        sum_probs = sum_deltas = None
        for idxs in groups.values():
            g = len(idxs)
            boxes_list = []
            for i in idxs:
                var = variants[i]
                boxes_v = proposals.boxes * var["scale"]
                if var["flip"]:
                    w_img = var["image_size"][:, 1:2]  # the variant's true width
                    boxes_v = torch.stack([w_img - boxes_v[..., 2], boxes_v[..., 1],
                                           w_img - boxes_v[..., 0], boxes_v[..., 3]], -1)
                boxes_list.append(boxes_v)
            feats_g = self.features(torch.cat([variants[i]["image"] for i in idxs]))
            pooled = self.pooled_rois(feats_g, torch.cat(boxes_list))  # [g*B*P, ...]
            del feats_g
            probs, bbox = self._score_rois(pooled, parts=g, with_transfer=with_transfer)
            # dx mirrored back for the flipped variants, one sign a variant
            sign = torch.tensor([[-1.0 if variants[i]["flip"] else 1.0, 1.0, 1.0, 1.0]
                                 for i in idxs], device=bbox.device)
            bbox4 = bbox.reshape(g, n_rows, -1, 4) * sign[:, None, None, :]
            probs_sum = probs.reshape(g, n_rows, -1).sum(0)
            deltas_sum = bbox4.reshape(g, n_rows, -1).sum(0)
            sum_probs = probs_sum if sum_probs is None else sum_probs + probs_sum
            sum_deltas = deltas_sum if sum_deltas is None else sum_deltas + deltas_sum
        # probabilities summed, not normalised (the reference's rcnn.py:163)
        mean_deltas = sum_deltas / float(len(variants))
        return sum_probs.reshape(b, p, -1), mean_deltas.reshape(b, p, -1), proposals

    def predict_tta(self, canonical_image: torch.Tensor, canonical_image_sizes: torch.Tensor,
                    variants, with_transfer: bool = True, proposal_boxes=None,
                    tta_topk: int = 0, proposal_valid=None) -> Detections:
        """Multi-scale + flip test-time augmentation (unit_tpu
        meta_arch.py:878-1020; the reference's rcnn.py:136-185).

        canonical_image [B, H, W, 3] in the MIN_SIZE_TEST frame with its
        content sizes [B, 2]; ``variants``, a list of {image [B, h, w, 3],
        image_size [B, 2], scale (a number: the variant's scale over the
        canonical one), flip (a bool)}.  The RPN proposes once, on the
        canonical image (K3); every variant scores those proposals, rescaled
        (and mirrored) into its own frame.  Class probabilities are SUMMED
        over the variants and box deltas AVERAGED, with dx mirrored back for
        flipped variants (unit_tpu's fix: the reference averages the raw
        flipped deltas); then the canonical proposals are decoded and go
        through one per-class NMS (K3), in the canonical frame.
        ``tta_topk`` > 0 keeps only the top-K canonical proposals by
        objectness.  Precomputed proposals (``proposal_boxes`` [B, P, 4] in
        the canonical frame, ``proposal_valid`` [B, P]) replace the RPN and
        the canonical backbone pass; every variant rescales (and mirrors)
        them as it does the RPN's, and their objectness is zero, so the top-K
        are the first K valid."""
        probs, deltas, proposals = self.predict_tta_raw(
            canonical_image, canonical_image_sizes, variants, with_transfer=with_transfer,
            proposal_boxes=proposal_boxes, tta_topk=tta_topk, proposal_valid=proposal_valid)
        return self._final_detections(probs, deltas, proposals, canonical_image_sizes)

    def predict_weak_only(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Detections:
        """WeakRCNN inference: the weak detector alone scores the RPN's
        proposals.  Its class probabilities are the SUM of the softmaxes of
        the OICR heads (padded with a zero background column for a head
        without one), its box deltas those of ``weak_detector.evaluation``;
        then per-class NMS as in :meth:`predict`."""
        feats = self.features(images)
        return self._predict_weak_only(feats, *self.rpn(feats), image_sizes)

    def _predict_weak_only(self, feats, logits, deltas, image_sizes) -> Detections:
        mc = self.mc
        proposals = self._test_proposals(feats, logits, deltas, image_sizes)
        b, p = proposals.boxes.shape[:2]
        pooled = self.pooled_rois(feats, proposals.boxes)
        weak_feats = self.box_features(pooled, "weak" if mc.multi_box_head else "box")
        weak_scores, weak_box_deltas = self.weak_detector.evaluation(weak_feats)
        probs = torch.softmax(weak_scores, dim=-1).sum(0)
        if probs.shape[-1] == mc.num_classes:  # no background column
            probs = torch.nn.functional.pad(probs, (0, 1))
        return self._final_detections(probs.reshape(b, p, -1),
                                      weak_box_deltas.reshape(b, p, -1), proposals, image_sizes)

    def _predict_masks(self, feats: torch.Tensor, dets: Detections) -> torch.Tensor:
        """Mask probabilities [B, D, M, M] of the final detections, padded
        rows included: ROIAlignV2 (K1) over their boxes, Res5 without the
        mean, the mask head, the transfer (from the similarity of these
        boxes' own features) and the delta head."""
        mc = self.mc
        b, d = dets.boxes.shape[:2]
        feats4d = self.box_head(self.pooled_rois(feats, dets.boxes), spatial_mean=False)
        logits, delta = self.mask_head(feats4d)
        if len(mc.novel_ids):
            sims = self.inference_similarity(feats4d.mean(dim=(1, 2)).to(torch.float32))
            logits = mask_lib.transfer_mask_logits(logits, sims["seg"], mc.base_ids,
                                                   mc.novel_ids)
        if delta is not None:
            logits = logits + delta
        masks = mask_lib.mask_rcnn_inference(logits, dets.classes.reshape(-1))
        return masks.reshape(b, d, *masks.shape[1:])
