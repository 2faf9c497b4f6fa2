"""k-shot fine-tuning and gradient accumulation: unit_tpu_torch vs unit_tpu.

The models are the shipped 10-shot split1 fine-tune recipe
(configs/VOC/FT/10_shot/VOC-RCNN-101-C4-split1-ft.yaml) and the flagship
recipe cut to depth 26, RES2_OUT_CHANNELS 16, a 160x224 canvas and 64
proposals, in f32, in the keep-everything sampling regime of
tests/test_torch_losses.py (the two packages cannot share an RNG).  Weights
are seeded flax trees (every ``*_ft`` and ``*_delta`` head non-zero) carried
across by load_jax_params.

Bounds, each with its reason:
  * predictor outputs and the transfer's gradients: 1e-5, two f32 matmuls of
    width 1024 or less in different summation orders (~1e-7);
  * the first update: losses to rtol 1e-4 and per leaf p1 - p0 within
    2e-3 * max|update_jax| + 1e-9 (tests/test_torch_train.py's bounds); a leaf
    unit_tpu leaves unchanged is bit-identical in the port, a leaf it moves
    moves;
  * predict_raw: tests/test_torch_slice.py's bounds (proposal boxes 0.05 px,
    probabilities and box deltas 2e-3);
  * the run loop: losses to rtol 1e-4 and the momentum to 2e-3 of each leaf's
    largest element (tests/test_torch_runner.py's bounds).
"""

import glob
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu_torch.data as tdata
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import seeded_image_loader, write_devkit
from tests.test_torch_losses import BASE, NOVEL, H, W, train_batches
from tests.test_torch_runner import TINY, jax_losses, optax_trace
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.engine import runner as jrunner
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import make_train_step as jmake_train_step
from unit_tpu.models import predictors as jpred
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint import (
    flax_leaves,
    load_jax_params,
    load_jax_train_state,
    read_checkpoint,
)
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_path, to_flax_layout
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine import TrainerFineTune, TrainerNoMeta, TrainerOnlyWeakFineTune, runner
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import predictors as tpred
from unit_tpu_torch.solver import build_optimizer

FT_YAML = "configs/VOC/FT/10_shot/VOC-RCNN-101-C4-split1-ft.yaml"
FLAGSHIP = "configs/VOC/VOC-RCNN-101-C4-split1.yaml"
FT_YAMLS = sorted(glob.glob("configs/VOC/FT/*/*-ft.yaml") + glob.glob("configs/COCO/*-ft.yaml"))
SMALL = [
    "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "600", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "600", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",          # > 2100 anchors
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128",     # > 64 proposals + 4 GT
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "TPU.COMPUTE_DTYPE", "float32", "SOLVER.WARMUP_ITERS", "0",
]
PRED_TOL = 1e-5
LOSS_RTOL = 1e-4
UPDATE_REL, UPDATE_ATOL = 2e-3, 1e-9
MOMENTUM_REL = 2e-3
BOX_TOL, PROB_TOL = 0.05, 2e-3


def both_cfgs(path, *opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(path)
        cfg.merge_from_list(list(opts))
    return jcfg, tcfg


def small_cfg(path=FT_YAML, *opts):
    return both_cfgs(path, *SMALL, *opts)[1]


def t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------ flags, trainers
@pytest.mark.parametrize("path,opts", [(p, ()) for p in FT_YAMLS] + [
    (FLAGSHIP, ("MODEL.ROI_HEADS.FAST_RCNN.NAME", "SupervisedDetectorOutputsWeakFineTune")),
    (FLAGSHIP, ("MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME", "WeakDetectorOutputsFT")),
], ids=lambda v: v if isinstance(v, str) else "-".join(v[1::2]) or "as-shipped")
def test_fine_tune_flags_and_trainer_follow_unit_tpu(path, opts):
    jcfg, tcfg = both_cfgs(path, *opts)
    jmc, tmc = JModelConfig.from_cfg(jcfg), ModelConfig.from_cfg(tcfg)
    for f in ("finetune", "weak_finetune_detach", "weak_detector_finetune", "novel_ids",
              "base_ids"):
        assert getattr(tmc, f) == getattr(jmc, f), f
    assert runner.trainer_name_for(tcfg) == jrunner.trainer_class_for(jcfg).__name__
    if opts[1:2] == ("SupervisedDetectorOutputsWeakFineTune",):  # fault 1: no *_ft heads
        assert (tmc.finetune, tmc.weak_finetune_detach) == (False, True)


def test_only_weak_fine_tune_trainer_still_waits_for_item_20():
    """Named when ENGINE.TRAINER TrainerOnlyWeakFineTune was not ported; it
    now holds that the explicit name wins over the recipe's fine-tune head
    (tests/test_torch_weak_only.py runs that trainer)."""
    cfg = small_cfg()
    cfg.ENGINE.TRAINER = "TrainerOnlyWeakFineTune"
    assert runner.trainer_class_for(cfg) is TrainerOnlyWeakFineTune
    assert runner.trainer_class_for(small_cfg()) is TrainerFineTune


# ------------------------------------------------------------ predictors
def predictor_pair(jmod, tmod, n=6, d=32, seed=0):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    params = randomize_params(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                              seed=seed + 1)
    load_jax_params(tmod, jax.tree.map(np.asarray, params))
    return x, params


def close(got, want, tol=PRED_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_supervised_predictor_with_fine_tune_heads():
    jmod = jpred.SupervisedPredictor(num_classes=20, finetune=True)
    tmod = tpred.SupervisedPredictor(32, 20, finetune=True)
    x, params = predictor_pair(jmod, tmod)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(t(x))
    assert set(got) == set(want) == {"delta_scores", "proposal_deltas", "ft_scores", "ft_deltas"}
    for k in want:
        assert float(got[k].detach().abs().max()) > 0, k
        close(got[k], want[k])


def test_weak_detector_predictor_with_delta_streams():
    jmod = jpred.WeakDetectorPredictor(num_classes=20, detector_temp=2.0, finetune=True,
                                       novel_ids=NOVEL)
    tmod = tpred.WeakDetectorPredictor(32, 20, detector_temp=2.0, finetune=True,
                                       novel_ids=NOVEL)
    x, params = predictor_pair(jmod, tmod, seed=4)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(t(x))
    for k in ("classifier_stream", "detection_stream"):
        close(got[k], want[k])
    for g, w in zip(got["oicr_scores"], want["oicr_scores"], strict=True):
        close(g, w)
    cls_j, bbox_j = jmod.apply({"params": params}, jnp.asarray(x),
                               method=jpred.WeakDetectorPredictor.evaluation)
    cls_t, bbox_t = tmod.evaluation(t(x))
    close(cls_t, cls_j)
    close(bbox_t, bbox_j)
    # the novel columns are the delta streams' alone
    delta = torch.stack([getattr(tmod, f"oicr_predictor_delta_{i}")(t(x)) for i in range(3)])
    assert torch.equal(cls_t[..., list(NOVEL)], delta[..., list(NOVEL)])


@pytest.mark.parametrize("detach", [False, True])
@pytest.mark.parametrize("per_roi", [False, True])
def test_transfer_gradients_and_detach(detach, per_roi):
    rng = np.random.RandomState(11)
    n, c = 7, 20
    scores = rng.randn(n, c + 1).astype(np.float32)
    deltas = rng.randn(n, 4 * c).astype(np.float32)
    shape = (n, len(NOVEL), len(BASE)) if per_roi else (len(NOVEL), len(BASE))
    sim = rng.rand(*shape).astype(np.float32)
    w_s = rng.randn(n, c + 1).astype(np.float32)
    w_d = rng.randn(n, 4 * c).astype(np.float32)

    def jloss(s, d):
        return (jnp.sum(w_s * jpred.transfer_scores(s, jnp.asarray(sim), np.asarray(BASE),
                                                      np.asarray(NOVEL), detach=detach))
                + jnp.sum(w_d * jpred.transfer_deltas(d, jnp.asarray(sim), np.asarray(BASE),
                                                        np.asarray(NOVEL), c, detach=detach)))

    gs_j, gd_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(deltas))
    s, d = t(scores).requires_grad_(), t(deltas).requires_grad_()
    out_s = tpred.transfer_scores(s, t(sim), BASE, NOVEL, detach=detach)
    out_d = tpred.transfer_deltas(d, t(sim), BASE, NOVEL, c, detach=detach)
    ((t(w_s) * out_s).sum() + (t(w_d) * out_d).sum()).backward()
    close(s.grad, gs_j)
    close(d.grad, gd_j)
    close(out_s, jpred.transfer_scores(jnp.asarray(scores), jnp.asarray(sim), np.asarray(BASE),
                                       np.asarray(NOVEL)))
    if detach:
        # the transferred terms pass nothing back to the base columns: each
        # input gets exactly its own output's weight
        assert torch.equal(s.grad, t(w_s))
        keep = np.zeros((n, c, 4), np.float32)
        keep[:, list(BASE)] = w_d.reshape(n, c, 4)[:, list(BASE)]
        assert torch.equal(d.grad, t(keep.reshape(n, 4 * c)))
    else:
        assert not torch.equal(s.grad, t(w_s))


# ------------------------------------------------------------ weights
FT_HEADS = {"supervised.cls_score_ft", "supervised.bbox_pred_ft",
            "weak_detector.classifier_stream_delta", "weak_detector.detection_stream_delta",
            "weak_detector.oicr_predictor_delta_0", "weak_detector.oicr_predictor_delta_1",
            "weak_detector.oicr_predictor_delta_2"}
BOTH_FT = ("MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME", "WeakDetectorOutputsFT")


def test_zero_init_heads_leave_the_seeded_base_weights_alone():
    base = WSRCNN(ModelConfig.from_cfg(small_cfg(FLAGSHIP)),
                  generator=torch.Generator().manual_seed(5)).state_dict()
    ft = WSRCNN(ModelConfig.from_cfg(small_cfg(FT_YAML, *BOTH_FT)),
                generator=torch.Generator().manual_seed(5)).state_dict()
    new = set(ft) - set(base)
    assert {k.rsplit(".", 1)[0] for k in new} == FT_HEADS and set(base) <= set(ft)
    assert all(torch.equal(ft[k], base[k]) for k in base)
    assert all(not ft[k].any() for k in new)


@pytest.fixture(scope="module")
def ft_pair():
    """unit_tpu's and the port's fine-tune model (both fine-tune heads) on one
    seeded flax tree."""
    jcfg, tcfg = both_cfgs(FT_YAML, *SMALL, *BOTH_FT)
    jmodel = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[64.0, 64.0]]))
    params = randomize_params(variables["params"], seed=3)
    tmodel = WSRCNN(ModelConfig.from_cfg(tcfg)).eval()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def test_jax_params_carry_the_fine_tune_leaves(ft_pair):
    _, params, tmodel = ft_pair
    want = flatten_tree(jax.tree.map(np.asarray, params))
    got = flax_leaves(tmodel)  # the parameters (FrozenBN and embeddings are buffers)
    new = {p for p in want if p.rsplit("/", 1)[0].replace("/", ".") in FT_HEADS}
    assert len(new) == 2 * len(FT_HEADS) and new <= set(got)  # kernel and bias, no new rule
    assert set(got) <= set(want)
    for path, value in got.items():
        np.testing.assert_array_equal(value, want[path], err_msg=path)


def test_predict_raw_with_fine_tune_heads_matches(ft_pair):
    jmodel, params, tmodel = ft_pair
    rng = np.random.RandomState(7)
    images = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    images[1, 150:], images[1, :, 200:] = 0.0, 0.0
    sizes = np.asarray([[H, W], [150, 200]], np.float32)
    probs_j, bbox_j, props_j, _ = jmodel.apply(
        {"params": params}, jnp.asarray(images), jnp.asarray(sizes), method=JWSRCNN.predict_raw)
    with torch.inference_mode():
        probs_t, bbox_t, props_t, _ = tmodel.predict_raw(t(images), t(sizes))
    for i in range(2):
        n = int(np.asarray(props_j.valid)[i].sum())
        assert n == int(props_t.valid[i].sum()) and n >= 32, (i, n)
        db = np.abs(props_t.boxes[i, :n].numpy() - np.asarray(props_j.boxes)[i, :n]).max()
        dp = np.abs(probs_t[i, :n].numpy() - np.asarray(probs_j)[i, :n]).max()
        dd = np.abs(bbox_t[i, :n].numpy() - np.asarray(bbox_j)[i, :n]).max()
        assert db < BOX_TOL and dp < PROB_TOL and dd < PROB_TOL, (i, db, dp, dd)
    # the *_ft terms are in them: one more logit of class 3 moves the probabilities
    bias = tmodel.supervised.cls_score_ft.bias
    with torch.no_grad():
        bias[3] += 5.0
        moved = tmodel.predict_raw(t(images), t(sizes))[0]
        bias[3] -= 5.0
    assert float((moved - probs_t).abs().max()) > 1e-3


# ------------------------------------------------------------ the first update
FIRST_UPDATE = {
    # the shipped freeze lists: only the RPN and the *_ft heads train
    "FineTune": (FT_YAML, (), TrainerFineTune),
    # no FAST_RCNN freeze list, so the detached transfer has base columns to
    # keep its gradient from
    "WeakFineTune": (FT_YAML, ("MODEL.ROI_HEADS.FAST_RCNN.NAME",
                               "SupervisedDetectorOutputsWeakFineTune",
                               "MODEL.FREEZE_LAYERS.FAST_RCNN", "[]"), TrainerFineTune),
    # base training with the weak detector's delta streams, both streams
    "WeakDetectorFT": (FLAGSHIP, BOTH_FT + ("MODEL.FREEZE_LAYERS.FAST_RCNN", "[]"),
                       TrainerNoMeta),
}


@pytest.fixture(scope="module", params=sorted(FIRST_UPDATE))
def first_update(request):
    path, opts, trainer_cls = FIRST_UPDATE[request.param]
    jcfg, cfg = both_cfgs(path, *SMALL, *opts)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    params = randomize_params(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                      jnp.asarray([[64.0, 64.0]]))["params"], seed=3)
    strong, weak = train_batches()
    if trainer_cls is TrainerFineTune:
        weak = None
    jax_before = flatten_tree(jax.tree.map(np.asarray, params))
    tx = jbuild_optimizer(jcfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    new_state, metrics = jmake_train_step(jm, tx)(
        state, jax.tree.map(jnp.asarray, strong),
        None if weak is None else jax.tree.map(jnp.asarray, weak), None, jax.random.PRNGKey(0))
    jax_after = flatten_tree(jax.tree.map(np.asarray, new_state.params))

    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, jax_before)
    before = flax_leaves(model)
    streams = [itertools.repeat(b) for b in (strong, weak) if b is not None]
    trainer = trainer_cls(model, build_optimizer(cfg, model), *streams, seed=0)
    trainer.init_state()
    got = trainer.run_step()
    return (request.param, {k: float(v) for k, v in metrics.items()}, got, jax_before,
            jax_after, before, flax_leaves(model), model, strong)


def test_first_update_matches_unit_tpu(first_update):
    case, want_losses, got_losses, jax_before, jax_after, before, after, _, _ = first_update
    assert set(want_losses) <= set(got_losses)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k], v, rtol=LOSS_RTOL, err_msg=f"{case} {k}")
    for path in before:
        np.testing.assert_array_equal(before[path], jax_before[path])
        want = jax_after[path] - jax_before[path]
        got = after[path] - before[path]
        if not want.any():
            assert not got.any(), (case, path)  # unchanged in unit_tpu: bit-identical here
            continue
        assert got.any(), (case, path)
        bound = UPDATE_REL * np.abs(want).max() + UPDATE_ATOL
        assert np.abs(got - want).max() <= bound, (case, path, np.abs(got - want).max(), bound)


def test_first_update_moves_what_the_recipe_trains(first_update):
    case, _, losses, _, _, before, after, model, strong = first_update
    moved = {p.rsplit("/", 1)[0] for p in before if (after[p] != before[p]).any()}
    if case == "FineTune":
        assert {m for m in moved if not m.startswith("rpn_head")} == {
            "supervised/cls_score_ft", "supervised/bbox_pred_ft"}
        assert any(m.startswith("rpn_head") for m in moved)
        assert "loss_im_cls" not in losses  # no weak stream
    elif case == "WeakFineTune":
        assert not any("_ft/" in p for p in before)  # this head has no *_ft heads
        assert {"supervised/cls_score_delta", "supervised/bbox_pred_delta"} <= moved
        assert not any(m.startswith(("backbone", "box_head", "weak_box_head")) for m in moved)
    else:
        assert {"weak_detector/classifier_stream_delta", "weak_detector/detection_stream_delta",
                "weak_detector/oicr_predictor_delta_0"} <= moved
        # the delta streams learn from the weak stream's losses alone
        model.zero_grad(set_to_none=True)
        losses = model.train_losses(torch.Generator().manual_seed(0),
                                    {k: t(v) for k, v in strong.items()}, None)
        torch.stack(list(losses.values())).sum().backward()
        deltas = [p for n, p in model.weak_detector.named_parameters() if "_delta" in n]
        assert deltas and all(p.grad is None for p in deltas)


# ------------------------------------------------------------ the run loop
@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"))


def cli(devkit, config, out, *opts):
    return runner.default_argument_parser().parse_args(
        ["--config-file", config, "--device", "cpu", "--data-root", devkit, *TINY,
         "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out), *opts])


def test_fine_tune_run_warm_starts_from_a_base_run_and_matches_unit_tpu(devkit, tmp_path):
    import unit_tpu.data.loader as jloader

    # a base run of the port: one step, one evaluation, its best snapshot
    base = tmp_path / "voc_split1_base"
    tdata.DatasetCatalog.clear()
    runner.run(cli(devkit, FLAGSHIP, base, "SOLVER.MAX_ITER", "1", "SOLVER.CHECKPOINT_PERIOD",
                   "1", "TEST.EVAL_PERIOD", "1"), image_loader=seeded_image_loader)
    assert (base / "best" / "model.pt").is_file() and not (base / "best" / "model").exists()

    # the fine-tune recipe names it as unit_tpu's orbax directory
    tdata.DatasetCatalog.clear()
    ft_opts = ("MODEL.WEIGHTS", str(base / "best" / "model"))
    cfg = runner.setup(cli(devkit, FT_YAML, tmp_path / "ft", *ft_opts))
    seed = cfg.SEED
    _, _, trainer = runner.build_everything(cfg, torch.device("cpu"), seed=seed,
                                            image_loader=seeded_image_loader)
    try:
        assert isinstance(trainer, TrainerFineTune) and trainer.weak_iter is None
        trainer.init_state()
        runner.load_initial_weights(cfg, trainer.model)
        snapshot = read_checkpoint(str(base / "best"))["model"]
        state = trainer.model.state_dict()
        assert all(torch.equal(state[k], v) for k, v in snapshot.items())
        assert {k for k in state if k not in snapshot} == {
            f"supervised.{h}.{p}" for h in ("cls_score_ft", "bbox_pred_ft")
            for p in ("weight", "bias")}
        assert not trainer.model.supervised.cls_score_ft.weight.any()
        missing = cfg.clone()
        missing.defrost()
        missing.MODEL.WEIGHTS = str(tmp_path / "no_run" / "best" / "model")
        with pytest.raises(FileNotFoundError, match="MODEL.WEIGHTS"):
            runner.load_initial_weights(missing, trainer.model)

        # against unit_tpu's runner: its fine-tune trainer on the same devkit,
        # from the same (seeded, non-zero) state
        jcfg = jget_cfg()
        jcfg.merge_from_file(FT_YAML)
        jcfg.merge_from_list([*TINY, "DATASETS.CLASSIFIER_DATAROOT", devkit,
                              "OUTPUT_DIR", str(tmp_path / "jft"), "MODEL.WEIGHTS", ""])
        jdata.DatasetCatalog.clear()
        jdata.RegisterVOC(jcfg, devkit).register_all()
        _, _, jtrainer, _ = jrunner.build_everything(jcfg, num_devices=1, seed=seed)
        jtrainer.close()  # its stream would read image files; use the seeded loader
        assert jtrainer.weak_iter is None
        jtrainer.strong_iter = iter(jloader.build_strong_loader(
            jcfg, seed=seed, image_loader=seeded_image_loader))
        jtrainer.init_state(sample_shape=(1, 96, 160, 3))
        jtrainer.state = jtrainer.state.replace(
            params=randomize_params(jtrainer.state.params, seed=3))
        load_jax_train_state(trainer.state, jax.tree.map(np.asarray, jtrainer.state.params),
                             optax_trace(jtrainer.state.opt_state), 0)
        for step in (1, 2):
            want = jax_losses(jtrainer.run_step())
            got = trainer.run_step()
            assert "loss_rpn_cls" in want and set(want) <= set(got)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
        trace = flatten_tree(optax_trace(jtrainer.state.opt_state))
        opt = trainer.optimizer.optimizer
        trained = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
        assert {n.split(".")[0] for n, _ in trained} == {"rpn_head", "supervised"}
        for name, p in trained:
            w = trace[flax_path(name, p)]
            g = to_flax_layout(opt.state[p]["momentum_buffer"].numpy())
            assert np.abs(g - w).max() <= MOMENTUM_REL * np.abs(w).max() + 1e-9, name
    finally:
        trainer.close()


def test_fine_tune_script_runs_on_the_card_unless_asked_for_the_cpu(devkit, tmp_path,
                                                                   monkeypatch):
    import runpy

    if torch.cuda.is_available():
        return  # the card's machine runs it in chip_smoke.py phase 11
    tdata.DatasetCatalog.clear()
    monkeypatch.setattr("sys.argv", ["finetune_VOC_torch.py", "--config-file", FT_YAML,
                                     "--data-root", devkit, *TINY, "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device.*--device cpu"):
        runpy.run_path("scripts/finetune_VOC_torch.py", run_name="__main__")


# ------------------------------------------------------------ TPU.GRAD_ACCUM
def test_grad_accum_step_matches_unit_tpu():
    jcfg, cfg = both_cfgs(FLAGSHIP, *SMALL)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    params = randomize_params(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                      jnp.asarray([[64.0, 64.0]]))["params"], seed=3)
    strong, weak = train_batches()
    micro_s = [{k: v[i:i + 1] for k, v in strong.items()} for i in range(2)]
    micro_w = [{k: v[i:i + 1] for k, v in weak.items()} for i in range(2)]
    jax_before = flatten_tree(jax.tree.map(np.asarray, params))
    tx = jbuild_optimizer(jcfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    stack = lambda ms: {k: jnp.stack([m[k] for m in ms]) for k in ms[0]}  # noqa: E731
    new_state, metrics = jmake_train_step(jm, tx, grad_accum=2)(
        state, stack(micro_s), stack(micro_w), None, jax.random.PRNGKey(0))
    jax_after = flatten_tree(jax.tree.map(np.asarray, new_state.params))

    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, jax_before)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.cycle(micro_s),
                            itertools.cycle(micro_w), seed=0, grad_accum=2)
    trainer.init_state()
    got = trainer.run_step()
    assert trainer.state.step == 1 and trainer.optimizer.scheduler.last_epoch == 1
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], float(v), rtol=LOSS_RTOL, err_msg=k)
    after = flax_leaves(model)
    moved = 0
    for path, value in after.items():
        want = jax_after[path] - jax_before[path]
        bound = UPDATE_REL * np.abs(want).max() + UPDATE_ATOL
        assert np.abs((value - jax_before[path]) - want).max() <= bound, path
        moved += bool(want.any())
    assert moved > 30


def test_trainer_groups_same_canvas_micro_batches():
    """The twin of tests/test_grad_accum.py::test_trainer_stacks_same_shape_microbatches."""
    shapes = [(2, 64, 96, 3), (2, 96, 64, 3), (2, 64, 96, 3), (2, 96, 64, 3)]
    batches = [{"image": np.full(s, i, np.float32)} for i, s in enumerate(shapes)]
    trainer = TrainerNoMeta.__new__(TrainerNoMeta)
    trainer.grad_accum = 2
    buffers = {}
    it = iter(batches)
    g1 = trainer._next_group(it, buffers)
    assert [b["image"].shape for b in g1] == [(2, 64, 96, 3)] * 2
    assert [float(b["image"][0, 0, 0, 0]) for b in g1] == [0.0, 2.0]
    assert list(buffers) == [(2, 96, 64, 3)]  # the other canvas waits
    g2 = trainer._next_group(it, buffers)
    assert [float(b["image"][0, 0, 0, 0]) for b in g2] == [1.0, 3.0] and buffers == {}


def test_grad_accum_seeds_and_resume(devkit, tmp_path, monkeypatch):
    from unit_tpu_torch.engine.train import step_seed

    # A = 1 keeps the seeds of existing runs; micro-batches never share one
    assert step_seed(3, 7) == (3 << 32) + 7
    seeds = {step_seed(3, s, i, 2) for s in range(50) for i in range(2)}
    assert len(seeds) == 100
    # a resume at step 3 skips 3 x A batches of each stream
    calls = []
    real = tdata.loader.StreamLoader.fast_forward
    monkeypatch.setattr(tdata.loader.StreamLoader, "fast_forward",
                        lambda self, n: (calls.append(n), real(self, n))[1])
    tdata.DatasetCatalog.clear()
    cfg = runner.setup(cli(devkit, FLAGSHIP, tmp_path, "TPU.GRAD_ACCUM", "2"))
    _, _, trainer = runner.build_everything(cfg, torch.device("cpu"), start_step=3,
                                            image_loader=seeded_image_loader)
    try:
        assert trainer.grad_accum == 2 and calls == [6, 6]  # strong and weak
        trainer.init_state()
        trainer.state.step = 3
        m = trainer.run_step()
        assert trainer.state.step == 4 and np.isfinite(m["total_loss"])
    finally:
        trainer.close()
