"""COCO detection and instance segmentation end to end: unit_tpu_torch vs unit_tpu.

The models are the shipped segm recipes (configs/COCO/COCO-RCNN-50-C4-split1-
segm.yaml and its fine-tune twin ...-segm-ft.yaml: R-50-C4, 80 classes, the
mask head, the mask transfer) cut to depth 26, RES2_OUT_CHANNELS 16, a
160x224 canvas and 64 proposals, in f32, in the keep-everything sampling
regime of tests/test_torch_losses.py (the two packages cannot share an RNG):
the ROI batch is exactly the 64 proposals plus the 4 GT slots, so every
candidate is sampled and the mask loss reads every slot.  Weights are seeded
flax trees carried across by load_jax_params.

Bounds, each with its reason:
  * losses, loss_mask included: rtol 1e-4, and every gradient within
    2e-3 * max|g_jax| + 1e-6 (tests/test_torch_losses.py's bounds: the same
    f32 math in different summation orders through R-26 and Res5);
  * predict: boxes within 0.05 px, scores within 2e-3 (tests/test_torch_
    slice.py's bounds), classes equal, mask probabilities within 1e-4 (a
    sigmoid of logits that differ by f32 rounding through Res5 and the head);
  * the run loop: the first two steps' losses to rtol 1e-4
    (tests/test_torch_runner.py's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu.data.coco as jcoco
import unit_tpu_torch.data as tdata
import unit_tpu_torch.data.coco as tcoco
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import seeded_image_loader
from tests.test_torch_runner import TINY, jax_losses, optax_trace
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.data.coco import RegisterCOCO as JRegisterCOCO
from unit_tpu.engine import runner as jrunner
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu_torch.checkpoint import load_jax_params, load_jax_train_state, read_checkpoint
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_leaves
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine import TrainerFineTune, TrainerNoMeta, runner
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

SEGM = "configs/COCO/COCO-RCNN-50-C4-split1-segm.yaml"
SEGM_FT = "configs/COCO/COCO-RCNN-50-C4-split1-segm-ft.yaml"
H, W, G = 160, 224, 4
SMALL = [
    "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "600", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "600", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",          # > 2100 anchors
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "68",      # = 64 proposals + 4 GT slots
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "TPU.COMPUTE_DTYPE", "float32",
    # random heads spread their probability over 81 classes: keep detections
    # above 1/81 instead of the recipe's 0.05
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.02",
]
# the run loop: tests/test_torch_runner.py's tiny sizes, with the ROI batch at
# its 32 proposals + 10 GT slots (unit_tpu's mask loss reads BATCH_SIZE_PER_IMAGE
# slots, so it may not exceed what the sampler emits)
RUN = [*TINY, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "42"]
LOSS_RTOL = 1e-4
GRAD_REL, GRAD_ATOL = 2e-3, 1e-6
BOX_TOL, PROB_TOL, MASK_TOL = 0.05, 2e-3, 1e-4


def both_cfgs(path, *opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(path)
        cfg.merge_from_list(list(opts))
    return jcfg, tcfg


def t(x):
    return torch.as_tensor(np.asarray(x))


def coco_batches(cfg, seed=1, b=2):
    """A strong batch (base-class GT boxes with blob masks in their frames)
    and a weak one (multi-hot labels over the 80 classes), on one canvas."""
    rng = np.random.RandomState(seed)
    base = np.asarray(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    gtb = np.zeros((b, G, 4), np.float32)
    gtb[..., 0] = rng.uniform(0, W - 90, (b, G))
    gtb[..., 1] = rng.uniform(0, H - 90, (b, G))
    gtb[..., 2:] = gtb[..., :2] + rng.uniform(30, 80, (b, G, 2))
    yy, xx = np.mgrid[:28, :28] / 28.0
    cy, cx, r = rng.uniform(0.3, 0.7, (3, b, G, 1, 1))
    # blobs of 0.95 on 0.1, not 1 on 0: a GT slot's 14 x 14 samples fall
    # midway between the 28 x 28 cells, where a 0/1 mask interpolates to
    # exactly 0.5 and the target's threshold turns on one f32 rounding (XLA's
    # fused arithmetic and PyTorch's differ there); no average of 0.1s and
    # 0.95s is 0.5
    inside = (yy - cy) ** 2 + (xx - cx) ** 2 < (0.2 + 0.3 * r) ** 2
    masks = np.where(inside, 0.95, 0.1).astype(np.float32)
    strong = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32),
                  gt_boxes=gtb, gt_classes=rng.choice(base, (b, G)).astype(np.int32),
                  gt_valid=np.asarray([[True, True, True, False]] * b), gt_masks=masks,
                  image_size=np.asarray([[H, W], [H - 10, W - 24]][:b], np.float32))
    labels = np.zeros((b, 80), np.float32)
    for i in range(b):
        labels[i, rng.choice(80, 3, replace=False)] = 1.0
    weak = dict(image=rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32), labels=labels,
                image_size=np.asarray([[H, W]] * b, np.float32))
    return strong, weak


@pytest.fixture(scope="module", params=["segm", "segm-ft"])
def pair(request):
    """unit_tpu's and the port's model of one recipe on one seeded flax tree,
    with each side's losses and gradients of one train step and its
    detections of two images."""
    path = SEGM if request.param == "segm" else SEGM_FT
    jcfg, tcfg = both_cfgs(path, *SMALL)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    params = randomize_params(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                                      jnp.asarray([[H, W]], jnp.float32))["params"], seed=3)
    strong, weak = coco_batches(tcfg)
    if request.param == "segm-ft":
        weak = None  # fine-tuning reads the strong stream alone

    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong),
                          None if weak is None else jax.tree.map(jnp.asarray, weak),
                          method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = WSRCNN(ModelConfig.from_cfg(tcfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(tcfg, tm)  # the recipe's freezes, as the trainer applies them
    losses_t = tm.train_losses(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in strong.items()},
                               None if weak is None else {k: t(v) for k, v in weak.items()})
    torch.stack(list(losses_t.values())).sum().backward()

    images = strong["image"].copy()
    images[1, 150:], images[1, :, 200:] = 0.0, 0.0
    sizes = np.asarray([[H, W], [150, 200]], np.float32)
    dets_j = jax.tree.map(np.asarray, jax.jit(lambda p, i, s: jm.apply(
        {"params": p}, i, s, method=JWSRCNN.predict))(params, jnp.asarray(images), jnp.asarray(sizes)))
    tm.eval()
    with torch.inference_mode():
        dets_t = tm.predict(t(images), t(sizes))
    return dict(case=request.param, tm=tm,
                losses_j={k: float(v) for k, v in losses_j.items()},
                losses_t={k: float(v.detach()) for k, v in losses_t.items()},
                grads_j=flatten_tree(jax.tree.map(np.asarray, grads_j)),
                grads_t=flax_leaves(tm, grads=True), dets_j=dets_j, dets_t=dets_t)


def test_config_distils_the_mask_fields(pair):
    mc = pair["tm"].mc
    assert mc.mask_on and mc.mask_fg_slots == 68 and mc.mask_num_conv == 0
    assert mc.mask_head_finetune == (pair["case"] == "segm-ft") == mc.finetune
    assert (pair["tm"].mask_head.predictor_delta is not None) == mc.mask_head_finetune
    assert mc.multi_box_head == (pair["case"] == "segm-ft")


def test_train_losses_match(pair):
    want, got = pair["losses_j"], pair["losses_t"]
    assert set(got) == set(want) and "loss_mask" in got
    assert ("loss_im_cls" in got) == (pair["case"] == "segm")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert got["loss_mask"] > 0.1  # a BCE over real targets, not an empty slice


def test_train_gradients_match(pair):
    grads_j, grads_t = pair["grads_j"], pair["grads_t"]
    trained = {k for k, v in grads_t.items() if v is not None}
    assert {"mask_head/deconv/kernel", "mask_head/predictor/kernel"} <= trained
    if pair["case"] == "segm-ft":
        assert "mask_head/predictor_delta/kernel" in trained
        assert not any(k.startswith(("backbone/", "weak_box_head/")) for k in trained)
        assert any(k.startswith("box_head/") for k in trained)  # not in the freeze list
    for path in trained:
        want, g = grads_j[path], grads_t[path]
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)


def test_predict_with_masks_matches(pair):
    dj, dt = pair["dets_j"], pair["dets_t"]
    # Res5 halves the 14 x 14 pooled map and the deconv doubles it back
    assert dt.masks.shape == dj.masks.shape == dt.boxes.shape[:2] + (14, 14)
    n_masks = 0
    for i in range(2):
        want = np.flatnonzero(dj.valid[i])
        got = np.flatnonzero(dt.valid[i].numpy())
        assert len(got) == len(want) > 0
        for k in want:
            match = [m for m in got if int(dt.classes[i, m]) == int(dj.classes[i, k])
                     and abs(float(dt.scores[i, m]) - float(dj.scores[i, k])) < PROB_TOL
                     and np.abs(dt.boxes[i, m].numpy() - dj.boxes[i, k]).max() < BOX_TOL]
            assert match, (i, k)
            diff = np.abs(dt.masks[i, match[0]].numpy() - dj.masks[i, k]).max()
            assert diff <= MASK_TOL, (i, k, diff)
            n_masks += 1
    assert n_masks >= 8 and float(dt.masks.min()) >= 0 and float(dt.masks.max()) <= 1


# ------------------------------------------------------------ the run loop
@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    import runpy

    root = str(tmp_path_factory.mktemp("shapes_coco"))
    runpy.run_path("scripts/make_shapes_coco_torch.py")["write_shapes_coco"](
        root, train_images=8, val_images=4, size=96, seed=7)
    return root


def cli(devkit, config, out, *opts):
    return runner.default_argument_parser().parse_args(
        ["--config-file", config, "--device", "cpu", "--data-root", devkit, *RUN,
         "OUTPUT_DIR", str(out), *opts])


def jax_trainer(config, devkit, out, seed):
    """unit_tpu's runner trainer for ``config`` on the devkit, its streams on
    the seeded image loader, its parameters a seeded flax tree."""
    import unit_tpu.data.loader as jloader

    jcfg = jget_cfg()
    jcfg.merge_from_file(config)
    jcfg.merge_from_list([*RUN, "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out)])
    jdata.DatasetCatalog.clear()
    JRegisterCOCO(jcfg, devkit).register_all()
    _, _, jtrainer, _ = jrunner.build_everything(jcfg, num_devices=1, seed=seed)
    jtrainer.close()
    jtrainer.strong_iter = iter(jloader.build_strong_loader(
        jcfg, seed=seed, image_loader=seeded_image_loader))
    if jtrainer.weak_iter is not None:
        jtrainer.weak_iter = iter(jloader.build_classifier_loader(
            jcfg, seed=seed + 1, image_loader=seeded_image_loader))
    jtrainer.init_state(sample_shape=(1, 96, 160, 3))
    jtrainer.state = jtrainer.state.replace(
        params=randomize_params(jtrainer.state.params, seed=3))
    return jtrainer


@pytest.mark.parametrize("config,trainer_cls", [(SEGM, TrainerNoMeta),
                                                (SEGM_FT, TrainerFineTune)])
def test_first_steps_match_unit_tpus_runner(devkit, tmp_path, config, trainer_cls, monkeypatch):
    # the devkit's 0/1 polygon masks as 0.1/0.95 in both packages: see coco_batches
    for mod in (jcoco, tcoco):
        real = mod.polygons_to_boxmask
        monkeypatch.setattr(mod, "polygons_to_boxmask",
                            lambda *a, real=real: np.where(real(*a), 0.95, 0.1).astype(np.float32))
    jtrainer = jax_trainer(config, devkit, tmp_path / "jax", seed=5)
    tdata.DatasetCatalog.clear()
    cfg = runner.setup(cli(devkit, config, tmp_path / "port"))
    _, _, trainer = runner.build_everything(cfg, torch.device("cpu"), seed=cfg.SEED,
                                            image_loader=seeded_image_loader)
    try:
        assert isinstance(trainer, trainer_cls)
        trainer.init_state()
        load_jax_train_state(trainer.state, jax.tree.map(np.asarray, jtrainer.state.params),
                             optax_trace(jtrainer.state.opt_state), 0)
        for step in (1, 2):
            want = jax_losses(jtrainer.run_step())
            got = trainer.run_step()
            assert "loss_mask" in want and set(want) <= set(got)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
    finally:
        trainer.close()


def finite_ap(results):
    assert set(results) >= {"bbox", "segm"}, results.keys()
    for task in ("bbox", "segm"):
        for k in ("AP", "AP50", "AP75", "novel_mean"):
            assert np.isfinite(results[task][k]), (task, k)


def test_segm_run_and_its_fine_tune_warm_start(devkit, tmp_path):
    """The port's runner on the segm recipe: two steps, a checkpoint and an
    evaluation (bbox and segm); then the segm-ft recipe warm-started from its
    best/model as the recipe spells it, two steps and an evaluation.  The
    snapshot lacks weak_box_head (MULTI_BOX_HEAD is False in the base
    recipe): it keeps its initialisation, frozen, and is not copied from
    box_head."""
    base = tmp_path / "coco_split1_segm_base"
    tdata.DatasetCatalog.clear()
    results = runner.run(cli(devkit, SEGM, base, "SOLVER.MAX_ITER", "2",
                             "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2"))
    finite_ap(results)
    assert (base / "best" / "model.pt").is_file()
    snapshot = read_checkpoint(str(base / "best"))["model"]
    assert any(k.startswith("mask_head.deconv") for k in snapshot)
    assert not any(k.startswith("weak_box_head.") for k in snapshot)

    made = []

    class Recording(TrainerFineTune):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    real = runner.TrainerFineTune
    runner.TrainerFineTune = Recording
    try:
        tdata.DatasetCatalog.clear()
        results = runner.run(cli(devkit, SEGM_FT, tmp_path / "ft", "MODEL.WEIGHTS",
                                 str(base / "best" / "model"), "SOLVER.MAX_ITER", "2",
                                 "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2"))
    finally:
        runner.TrainerFineTune = real
    finite_ap(results)
    (trainer,) = made
    model = trainer.model
    assert len(trainer.metrics_history) == 2
    assert all(np.isfinite(m["loss_mask"]) for m in trainer.metrics_history)
    final = {k: v for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    frozen_same = [k for k in snapshot if k not in trainable and torch.equal(final[k], snapshot[k])]
    assert len(frozen_same) == len([k for k in snapshot if k not in trainable])
    moved = {k.split(".")[0] for k in trainable
             if k in snapshot and not torch.equal(final[k], snapshot[k])}
    assert {"box_head", "mask_head"} <= moved
    assert any(".predictor_delta." in k for k in trainable)
    # weak_box_head: new, frozen, at its seeded initialisation, not box_head's copy
    fresh = WSRCNN(model.mc, generator=torch.Generator().manual_seed(trainer.seed)).state_dict()
    weak = [k for k in final if k.startswith("weak_box_head.")]
    assert weak and not any(k in trainable for k in weak)
    assert all(torch.equal(final[k], fresh[k]) for k in weak)
    assert not all(torch.equal(final[k], final["box_head." + k[len("weak_box_head."):]])
                   for k in weak)


def test_train_net_script_runs_on_the_card_unless_asked_for_the_cpu(devkit, tmp_path,
                                                                    monkeypatch):
    import runpy

    if torch.cuda.is_available():
        return  # the card's machine runs the COCO recipes in chip_smoke.py phase 12
    tdata.DatasetCatalog.clear()
    monkeypatch.setattr("sys.argv", ["train_net_torch.py", "--config-file", SEGM,
                                     "--data-root", devkit, *RUN, "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device.*--device cpu"):
        runpy.run_path("scripts/train_net_torch.py", run_name="__main__")
