"""Registry-name validation for the public config surface (the port's own
copy of unit_tpu/config/validate.py).

The reference dispatches every architectural choice through Detectron2
registries (SURVEY.md §1); an unknown name there raises a registry KeyError
at build time.  This rebuild folds the class hierarchy into config-flag
routing inside ``WSRCNN`` (models/meta_arch.py), where string matching like
``"FineTune" in name`` would otherwise let unknown names fall through to the
Base semantics silently — e.g. a config naming the reference's abstract,
UNREGISTERED ``FastRCNNOutputsBase`` (reference fast_rcnn.py:132 — no
``@FAST_RCNN_REGISTRY.register()`` decorator, ``losses()`` raises
NotImplementedError) must fail loudly here exactly as it would there.

``validate_registry_names(cfg)`` is called from ``engine.runner.setup()``
and from ``ModelConfig.from_cfg``; each supported set below mirrors one
reference registry (file:line in the set's comment).
"""

from __future__ import annotations

# META_ARCH_REGISTRY: reference meta_arch/rcnn.py:22,188,432,545 (+ d2's
# GeneralizedRCNN, the defaults.py placeholder every shipped YAML overrides).
META_ARCHITECTURES = frozenset({
    "GeneralizedRCNN",
    "WeakRCNN",
    "WeaklySupervisedRCNN",
    "WeaklySupervisedRCNNNoMeta",
    "WeaklySupervisedRCNNRPN",
})

# BACKBONE_REGISTRY: d2 build_resnet_backbone + reference backbone.py:59,83,104
# (unit_tpu registers both the d2-style build_* names and the reference's
# class-name aliases, models/backbones.py:196-204).
BACKBONES = frozenset({
    "build_resnet_backbone",
    "build_vgg_backbone", "VGG",
    "build_vgg_cnn_f_backbone", "VGG_CNN_F",
    "build_inception_resnet_v2_backbone", "InceptionResNetV2",
})

# PROPOSAL_GENERATOR_REGISTRY: reference rpn.py:19 + d2 RPN/PrecomputedProposals.
PROPOSAL_GENERATORS = frozenset({"RPN", "WSRPN", "PrecomputedProposals"})

# ROI_HEADS_REGISTRY: reference roi_heads.py:29,135,489,594,647,825 (+ d2's
# Res5ROIHeads, the defaults.py placeholder).
ROI_HEADS = frozenset({
    "Res5ROIHeads",
    "WeakDetectorHead",
    "WSROIHead",
    "WSROIHeadNoMeta",
    "WSROIHeadFineTune",
    "WSROIHeadNoMetaWithMask",
    "WSROIHeadWithMaskFineTune",
})

# FAST_RCNN_REGISTRY: reference fast_rcnn.py:287-292,470,535.  Note that
# FastRCNNOutputsBase (:132) is deliberately ABSENT — it is not registered in
# the reference either.
FAST_RCNN_PREDICTORS = frozenset({
    "WeakDetectorOutputsBaseWrapper",
    "SupervisedDetectorOutputsBase",
    "SupervisedDetectorOutputsFineTune",
    "SupervisedDetectorOutputsWeakFineTune",
})

# WEAK_DETECTOR_FAST_RCNN_REGISTRY: reference weak_detector_fast_rcnn.py:38,522.
WEAK_DETECTORS = frozenset({"WeakDetectorOutputsBase", "WeakDetectorOutputsFT"})

# VISUAL_ATTENTION_HEAD_REGISTRY: reference visual_attention_head.py:146,179,210,314.
VISUAL_ATTENTION_HEADS = frozenset({
    "MahalanobisSimilarity",
    "MeanSimilarity",
    "MeanMatrixSimilarity",
    "MeanMatrixSimilarityLocatron",
})

# ROI_BOX_HEAD_REGISTRY: reference box_head.py:19,47,92,138,144,169 ("" = the
# defaults.py empty placeholder; C4 configs that pool straight into Res5 may
# leave it unset).
BOX_HEADS = frozenset({
    "",
    "VGGConvFCHead",
    "Res5BoxHead",
    "Res5BoxHeadNOTE",
    "Res5BoxHeadWithMask",
    "VGGCNNFBoxHead",
    "InceptionResNetHead",
})

# ROI_MASK_HEAD_REGISTRY: reference mask_head.py:15,40 (+ d2's
# MaskRCNNConvUpsampleHead defaults.py placeholder; only read when MASK_ON).
MASK_HEADS = frozenset({
    "MaskRCNNConvUpsampleHead",
    "MaskRCNNConvUpsampleHeadWithSimilarity",
    "MaskRCNNConvUpsampleHeadWithFineTune",
})

_REGISTRIES = (
    # (cfg getter, supported set, registry label)
    (lambda c: c.MODEL.META_ARCHITECTURE, META_ARCHITECTURES, "MODEL.META_ARCHITECTURE"),
    (lambda c: c.MODEL.BACKBONE.NAME, BACKBONES, "MODEL.BACKBONE.NAME"),
    (lambda c: c.MODEL.PROPOSAL_GENERATOR.NAME, PROPOSAL_GENERATORS, "MODEL.PROPOSAL_GENERATOR.NAME"),
    (lambda c: c.MODEL.ROI_HEADS.NAME, ROI_HEADS, "MODEL.ROI_HEADS.NAME"),
    (lambda c: c.MODEL.ROI_HEADS.FAST_RCNN.NAME, FAST_RCNN_PREDICTORS, "MODEL.ROI_HEADS.FAST_RCNN.NAME"),
    (lambda c: c.MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME, WEAK_DETECTORS, "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME"),
    (lambda c: c.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME, VISUAL_ATTENTION_HEADS, "MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME"),
    (lambda c: c.MODEL.ROI_BOX_HEAD.NAME, BOX_HEADS, "MODEL.ROI_BOX_HEAD.NAME"),
    (lambda c: c.MODEL.ROI_MASK_HEAD.NAME, MASK_HEADS, "MODEL.ROI_MASK_HEAD.NAME"),
)


def validate_registry_names(cfg) -> None:
    """Raise KeyError for any registry-dispatched name outside its supported set.

    The error lists the supported names, mirroring Detectron2's registry
    KeyError message shape so misspelled configs fail at setup, not silently
    fall through ``dict.get`` defaults mid-build.
    """
    problems = []
    for getter, supported, label in _REGISTRIES:
        try:
            name = getter(cfg)
        except (AttributeError, KeyError):
            continue  # partial cfg (unit tests build slimmed-down nodes)
        if name not in supported:
            problems.append(
                f"{label} = {name!r} is not a supported name; "
                f"choose one of {sorted(n for n in supported if n)}"
            )
    if problems:
        raise KeyError("; ".join(problems))
