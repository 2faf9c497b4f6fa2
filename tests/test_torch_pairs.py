"""The backbone and box-head pairings no recipe ships: unit_tpu_torch vs unit_tpu.

unit_tpu's flax modules infer their input widths, so its WSRCNN builds any
backbone (ResNet-C4, VGG16, VGG-CNN-F, InceptionResNetV2) under any box head
(Res5, the VGG fc heads, the InceptionResNetV2 tail), with the visual
attention head's Res5 and the mask head over any of them.  The port builds
each over the backbone's channels.  Held here on shared weights
(load_jax_params of a seeded flax tree): each pairing no recipe ships, a
train step's losses; the new weight trees (the meta head over 256, 512 and
1088 channels, the mask head over 1536) carried over and through the
port's checkpointer.  The paths the shipped recipes reach with two keys
changed (the note with masks, the note and the dock with the meta stream)
are tests/test_torch_pair_paths.py, which shares this module's size,
helpers and bounds.

Size: 128 x 160 canvases, ResNet-C4 at depth 26 and RES2_OUT_CHANNELS 16
(the Res5 heads and the meta head at that width too), InceptionResNetV2 cut
to one block35 and one block17 and its tail to one Block8 in both packages
(their registries patched for the module), VGG16 and VGG-CNN-F whole; the
VGG fc heads over 2 x 2 pooled maps (fc6 over 17x17x1088 would hold 1.3 G
weights); 8 proposals an image in the keep-everything sampling regime of
tests/test_torch_losses.py (the ROI batch is the proposals plus the 4 GT
slots), f32.

Bounds: losses rtol 1e-4; every gradient within 1e-3 * max|g_jax| + 1e-6;
predict_raw's proposals within 0.05 px, probabilities and box deltas within
2e-3; final boxes within 0.05 px, scores within 2e-3, mask probabilities
within 1e-4 (tests/test_torch_coco_slice.py's); AP equal to 1e-9.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_dock_slice import proposals
from tests.test_torch_note import param_shapes
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.models import backbones as jbb
from unit_tpu.models import box_heads as jbh
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.solver.build import is_frozen as jis_frozen
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_leaves
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import backbones as tbb
from unit_tpu_torch.models import box_heads as tbh
from unit_tpu_torch.solver import build_optimizer

FLAGSHIP = "configs/VOC/VOC-RCNN-101-C4-split1.yaml"
META = "configs/VOC/VOC-RCNN-101-C4-split1-meta.yaml"
NOTE = "configs/COCO/COCO-RCNN-50-C4-split1-note.yaml"
DOCK = "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"
H, W, G, SHOT = 128, 160, 4, 64
SMALL = [
    "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "300", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "300", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",          # > the anchors of an 8 x 10 map
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "12",      # = 8 proposals + 4 GT slots
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "TEST.DETECTIONS_PER_IMAGE", "20",  # the note's mask path pools each at 17x17x1088
]
MASKS = ["MODEL.MASK_ON", "True", "MODEL.ROI_HEADS.NAME", "WSROIHeadNoMetaWithMask"]
META_KEYS = ["MODEL.META_ARCHITECTURE", "WeaklySupervisedRCNN", "MODEL.ROI_HEADS.NAME",
             "WSROIHead"]
LOSS_RTOL, GRAD_REL, GRAD_ATOL = 1e-4, 1e-3, 1e-6
BOX_TOL, PROB_TOL, MASK_TOL = 0.05, 2e-3, 1e-4
INCEPTION = ("InceptionResNetV2", "build_inception_resnet_v2_backbone")


@contextlib.contextmanager
def reduced_inception_registries():
    """InceptionResNetV2 at one block35 and one block17, its tail at one
    Block8, in both packages' registries while the context lasts."""
    jreg, jheads = jbb.BACKBONE_REGISTRY._obj_map, jbh.BOX_HEAD_REGISTRY._obj_map
    treg, theads = tbb.BACKBONE_REGISTRY._obj_map, tbh.BOX_HEAD_REGISTRY._obj_map
    saved = [dict(r) for r in (jreg, jheads, treg, theads)]
    for name in INCEPTION:
        jreg[name] = functools.partial(jbb.InceptionResNetV2, num_block35=1, num_block17=1)
        treg[name] = lambda dtype=torch.float32, generator=None, **_: tbb.InceptionResNetV2(
            1, 1, dtype=dtype, generator=generator)
    jheads["InceptionResNetHead"] = functools.partial(jbh.InceptionResNetHead, num_block8=1)
    theads["InceptionResNetHead"] = (
        lambda in_channels, dtype=torch.float32, generator=None, **_:
        tbh.InceptionResNetHead(in_channels, num_block8=1, dtype=dtype, generator=generator))
    try:
        yield
    finally:
        for reg, old in zip((jreg, jheads, treg, theads), saved):
            reg.clear()
            reg.update(old)


@pytest.fixture(scope="module", autouse=True)
def reduced_inception():
    with reduced_inception_registries():
        yield


def both_cfgs(path, *opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(path)
        cfg.merge_from_list(SMALL + list(opts))
    return jcfg, tcfg


def t(x):
    return torch.as_tensor(np.asarray(x))


def batches(cfg, seed=1, b=2):
    """A strong batch (base-class GT boxes, under MODEL.MASK_ON with 0.1/0.95
    blob masks in their frames: tests/test_torch_coco_slice.py's coco_batches)
    and a weak one (multi-hot labels), on one canvas; under
    MODEL.LOAD_PROPOSALS both carry 8 and 12 precomputed proposals."""
    rng = np.random.RandomState(seed)
    base = np.asarray(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    c = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    gtb = np.zeros((b, G, 4), np.float32)
    gtb[..., 0] = rng.uniform(0, W - 70, (b, G))
    gtb[..., 1] = rng.uniform(0, H - 70, (b, G))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(24, 64, (b, G, 2))
    strong = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32),
                  gt_boxes=gtb, gt_classes=rng.choice(base, (b, G)).astype(np.int32),
                  gt_valid=np.asarray([[True, True, True, False]] * b),
                  image_size=np.asarray([[H, W], [H - 8, W - 16]][:b], np.float32))
    if cfg.MODEL.MASK_ON:
        yy, xx = np.mgrid[:28, :28] / 28.0
        cy, cx, r = rng.uniform(0.3, 0.7, (3, b, G, 1, 1))
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 < (0.2 + 0.3 * r) ** 2
        strong["gt_masks"] = np.where(inside, 0.95, 0.1).astype(np.float32)
    labels = np.zeros((b, c), np.float32)
    for i in range(b):
        labels[i, rng.choice(c, 3, replace=False)] = 1.0
    weak = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[H, W]] * b, np.float32))
    if cfg.MODEL.LOAD_PROPOSALS:
        strong["proposals"], strong["proposals_valid"] = proposals(rng, gtb, 8, H, W)
        weak["proposals"], weak["proposals_valid"] = proposals(rng, gtb, 12, H, W)
    return strong, weak


def support_batch(cfg, seed=4, shots=1):
    """One shot a base class on a SHOT-pixel square canvas, one GT box each;
    one class without support, one shot on the whole canvas."""
    rng = np.random.RandomState(seed)
    c = len(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    image = rng.uniform(0, 255, (c, shots, SHOT, SHOT, 3)).astype(np.float32)
    xy = rng.uniform(0, SHOT * 0.5, (c, shots, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(12, SHOT * 0.5, (c, shots, 2))], -1)
    boxes = boxes.astype(np.float32)
    boxes[2, 0] = [0, 0, SHOT, SHOT]
    valid = np.ones(c, bool)
    valid[6] = False
    image[6] = 0.0
    return {"image": image, "boxes": boxes, "class_valid": valid}


def make_pair(jcfg, tcfg, seed=3):
    """unit_tpu's model and a seeded flax tree of it (the shapes from
    jax.eval_shape), and the port's model on that tree with the recipe's
    freezes."""
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    shapes = param_shapes(jm, np.zeros((1, H, W, 3), np.float32),
                          np.asarray([[H, W]], np.float32))
    params = randomize_params(shapes, seed=seed)
    with torch.device("meta"):  # no draws: load_jax_params sets every tensor
        tm = WSRCNN(ModelConfig.from_cfg(tcfg))
    load_jax_params(tm.to_empty(device="cpu"), jax.tree.map(np.asarray, params))
    build_optimizer(tcfg, tm)  # the recipe's freezes, as the trainer applies them
    return jm, params, tm


def jax_train(jm, params, strong, weak, meta=None, grads=True):
    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          meta=None if meta is None else jax.tree.map(jnp.asarray, meta),
                          method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    if not grads:
        return {k: float(v) for k, v in jax.jit(loss_fn)(params)[1].items()}, None
    (_, losses), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return ({k: float(v) for k, v in losses.items()},
            flatten_tree(jax.tree.map(np.asarray, g)))


def torch_train(tm, strong, weak, meta=None, grads=True):
    tm.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(grads):
        losses = tm.train_losses(torch.Generator().manual_seed(0),
                                 {k: t(v) for k, v in strong.items()},
                                 {k: t(v) for k, v in weak.items()},
                                 meta=None if meta is None else {k: t(v) for k, v in meta.items()})
    if not grads:
        return {k: float(v) for k, v in losses.items()}, None
    torch.stack(list(losses.values())).sum().backward()
    return {k: float(v.detach()) for k, v in losses.items()}, flax_leaves(tm, grads=True)


def assert_losses_match(want, got, keys=()):
    assert set(got) == set(want) and set(keys) <= set(got), (sorted(got), sorted(want))
    for k in want:
        assert np.isfinite(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def assert_gradients_match(jcfg, grads_j, grads_t, trained=()):
    """Every port gradient against jax.grad's; a leaf the port does not train
    is frozen by the recipe (unit_tpu's is_frozen) or has no gradient in
    unit_tpu either; ``trained``, prefixes that must have gradients."""
    # FrozenBN's statistics and the GloVe table are buffers in the port
    assert set(grads_t) == {k for k in grads_j if k != "embeddings" and "_bn/" not in k}
    for path, g in grads_t.items():
        want = grads_j[path]
        if g is None:
            assert jis_frozen(path, jcfg) or not np.any(want), path
            continue
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)
    for prefix in trained:
        assert any(k.startswith(prefix) and v is not None and np.any(v)
                   for k, v in grads_t.items()), prefix


# ------------------------------------------------ the pairings no recipe ships
VGG_HEAD = ["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "2"]
PAIRINGS = {
    "res5_over_vgg16": ["MODEL.BACKBONE.NAME", "VGG"],
    "res5_over_vgg_cnn_f": ["MODEL.BACKBONE.NAME", "VGG_CNN_F"],
    "res5_over_inception": ["MODEL.BACKBONE.NAME", "InceptionResNetV2"],
    "vgg_conv_fc_over_resnet": ["MODEL.ROI_BOX_HEAD.NAME", "VGGConvFCHead", *VGG_HEAD],
    "vgg_cnn_f_head_over_resnet": ["MODEL.ROI_BOX_HEAD.NAME", "VGGCNNFBoxHead", *VGG_HEAD],
    "vgg_conv_fc_over_inception": ["MODEL.BACKBONE.NAME", "InceptionResNetV2",
                                   "MODEL.ROI_BOX_HEAD.NAME", "VGGConvFCHead", *VGG_HEAD],
    "vgg_cnn_f_head_over_inception": ["MODEL.BACKBONE.NAME", "InceptionResNetV2",
                                      "MODEL.ROI_BOX_HEAD.NAME", "VGGCNNFBoxHead", *VGG_HEAD],
    "inception_head_over_resnet": ["MODEL.ROI_BOX_HEAD.NAME", "InceptionResNetHead"],
    "inception_head_over_vgg16": ["MODEL.BACKBONE.NAME", "VGG",
                                  "MODEL.ROI_BOX_HEAD.NAME", "InceptionResNetHead"],
    "inception_head_over_vgg_cnn_f": ["MODEL.BACKBONE.NAME", "VGG_CNN_F",
                                      "MODEL.ROI_BOX_HEAD.NAME", "InceptionResNetHead"],
    "meta_over_vgg16": ["MODEL.BACKBONE.NAME", "VGG", "MODEL.ROI_HEADS.NAME", "WSROIHead"],
}


@pytest.mark.parametrize("opts", list(PAIRINGS.values()), ids=list(PAIRINGS))
def test_pairing_matches_unit_tpu(opts):
    """The flagship recipe (the meta recipe for the meta stream) with its
    backbone or box head swapped, 14 x 14 ROIAlignV2 (2 x 2 under a VGG
    head): one train step's losses against unit_tpu's, which run every
    module the pairing joins (the backbone's map through the pooler and the
    head into the supervised and weak predictors, the meta head over the
    pooled slots and the shots).  Predict runs the same modules on the
    proposals: tests/test_torch_pair_paths.py holds it on the recipes'
    paths."""
    yaml = META if "WSROIHead" in opts else FLAGSHIP
    jcfg, tcfg = both_cfgs(yaml, *opts)
    jm, params, tm = make_pair(jcfg, tcfg)
    assert tm.box_head.out_channels == tm.supervised.cls_score_delta.weight.shape[1]
    strong, weak = batches(tcfg)
    meta = support_batch(tcfg) if tm.mc.use_meta else None
    keys = {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_im_cls", "loss_oicr_3"}
    if meta is not None:
        keys |= {"loss_rank_margin", "loss_rank_reg", "loss_rank_cls"}
    assert_losses_match(jax_train(jm, params, strong, weak, meta, grads=False)[0],
                        torch_train(tm, strong, weak, meta, grads=False)[0], keys)


# ----------------------------------------------------------- the new weight trees
@pytest.mark.parametrize("yaml,opts,channels", [
    # the dock's fc6 over 2 x 2 maps: its 9216 x 4096 would fill the checkpoint
    (DOCK, [*META_KEYS, "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "2"], 256),
    (FLAGSHIP, ["MODEL.BACKBONE.NAME", "VGG", *META_KEYS], 512),
    (NOTE, META_KEYS, 1088), (NOTE, MASKS, 1536)],
    ids=["meta_head_over_256", "meta_head_over_512", "meta_head_over_1088",
         "mask_head_over_1536"])
def test_new_trees_carry_over_and_round_trip(yaml, opts, channels, tmp_path):
    """unit_tpu's visual_attention/meta_box_head with its first block over
    VGG-CNN-F's, VGG16's or InceptionResNetV2's channels, and its mask_head
    over the InceptionResNetV2 tail's 1536: load_jax_params puts every leaf
    in place (strictly: no leaf left over, no tensor unset), flax_leaves
    gives each back bit for bit, and the port's checkpointer writes and
    restores them into a fresh model unchanged."""
    from unit_tpu_torch.checkpoint import Checkpointer
    from unit_tpu_torch.engine.train import TrainState

    jcfg, tcfg = both_cfgs(yaml, *opts)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    tree = jax.tree.map(np.asarray, randomize_params(param_shapes(
        jm, np.zeros((1, H, W, 3), np.float32), np.asarray([[H, W]], np.float32)), seed=9))
    part = "visual_attention/meta_box_head" if "WSROIHead" in opts else "mask_head"
    flat = {k: v for k, v in flatten_tree(tree).items() if k.startswith(part + "/")}
    first = (flat[f"{part}/res5/block0/conv1/kernel"] if part != "mask_head"
             else flat["mask_head/deconv/kernel"])
    assert first.shape[2] == channels
    with torch.device("meta"):
        tm = WSRCNN(ModelConfig.from_cfg(tcfg))
    tm = load_jax_params(tm.to_empty(device="cpu"), tree)
    back = flax_leaves(tm)
    assert {k for k in back if k.startswith(part + "/")} == {
        k for k in flat if "_bn/" not in k}
    for k, v in flat.items():
        if "_bn/" not in k:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    path = Checkpointer(str(tmp_path)).save(3, TrainState(tm, build_optimizer(tcfg, tm), 3),
                                            wait=True)
    fresh = WSRCNN(ModelConfig.from_cfg(tcfg), generator=torch.Generator().manual_seed(1))
    state = Checkpointer(str(tmp_path)).restore(state=TrainState(
        fresh, build_optimizer(tcfg, fresh), 0))
    assert state.step == 3 and path
    prefix = part.replace("/", ".") + "."
    want = {k: v for k, v in tm.state_dict().items() if k.startswith(prefix)}
    assert want and all(torch.equal(fresh.state_dict()[k], v) for k, v in want.items())
