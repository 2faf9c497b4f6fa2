"""The run loop of unit_tpu_torch (engine.runner.run) on the CPU at a tiny
config, on a synthetic devkit with images from a seeded loader.

  * 6 steps uninterrupted: checkpoints at 3 and 6, a best snapshot, an AP dict;
  * the same run stopped by ``request_stop`` (what SIGTERM does) and resumed
    with ``--resume``: the per-step losses of the resumed steps and every
    tensor of the final checkpoint are bit-identical to the uninterrupted
    run's (same data through ``fast_forward``, the step's generator seeded
    from (seed, step), deterministic CPU kernels);
  * ``--eval-only --resume`` on the finished run returns the in-run evaluation
    exactly;
  * against unit_tpu's runner on the same devkit, from the same train state
    carried over by ``load_jax_train_state``, in the keep-everything sampling
    regime of tests/test_torch_losses.py: the losses of the first 2 steps to
    rtol 1e-4 (the bound of tests/test_torch_train.py), the momentum after 2
    steps to 2e-3 of each leaf's largest element, and, from unit_tpu's state
    at step 2 (momentum included), the third step's losses to rtol 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu_torch.data as tdata
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import seeded_image_loader, write_devkit
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.engine import runner as jrunner
from unit_tpu_torch.checkpoint import load_jax_train_state, read_checkpoint
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_path, to_flax_layout
from unit_tpu_torch.data.loader import StreamLoader
from unit_tpu_torch.engine import runner
from unit_tpu_torch.engine.train import TrainerNoMeta

LOSS_RTOL = 1e-4
MOMENTUM_REL = 2e-3

TINY = [
    "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "200", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "INPUT.MIN_SIZE_TRAIN", "(80, 96)", "INPUT.MAX_SIZE_TRAIN", "160",
    "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "2",
    "SOLVER.MAX_ITER", "6", "SOLVER.CHECKPOINT_PERIOD", "3", "TEST.EVAL_PERIOD", "3",
    "TPU.MAX_GT_BOXES", "10", "TPU.COMPUTE_DTYPE", "float32", "SEED", "5",
]
FLAGSHIP = "configs/VOC/VOC-RCNN-101-C4-split1.yaml"


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"))


def cli(devkit, out, *flags, opts=()):
    return runner.default_argument_parser().parse_args(
        ["--config-file", FLAGSHIP, "--device", "cpu", "--data-root", devkit, *flags,
         *TINY, "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out), *opts])


class Recording(TrainerNoMeta):
    """TrainerNoMeta that keeps itself and can stop after a given step."""

    made = []
    stop_after = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        Recording.made.append(self)

    def run_step(self):
        metrics = super().run_step()
        if self.state.step == Recording.stop_after:
            self.request_stop()  # what the SIGTERM handler does
        return metrics


def run_recorded(monkeypatch, args, stop_after=None):
    """run(args) -> (results, {step: losses}) of the steps this call took."""
    tdata.DatasetCatalog.clear()
    monkeypatch.setattr(runner, "TrainerNoMeta", Recording)
    Recording.made, Recording.stop_after = [], stop_after
    results = runner.run(args, image_loader=seeded_image_loader)
    trainer = Recording.made[-1]
    first = trainer.state.step - len(trainer.metrics_history)
    losses = {first + 1 + k: {n: v for n, v in m.items() if n != "data_time"}
              for k, m in enumerate(trainer.metrics_history)}
    assert not trainer.strong_iter.thread.is_alive()  # run() closed the streams
    return results, losses


def strip_time(results):
    return {k: v for k, v in results.items() if k != "inference_seconds_per_image"}


def checkpoint_tensors(path):
    payload = read_checkpoint(path)
    out = dict(payload["model"])
    for k, st in payload["optimizer"]["state"].items():
        out[f"momentum.{k}"] = st["momentum_buffer"]
    return payload, out


@pytest.fixture(scope="module")
def whole_run(devkit, tmp_path_factory):
    out = tmp_path_factory.mktemp("run_a")
    with pytest.MonkeyPatch.context() as mp:
        results, losses = run_recorded(mp, cli(devkit, out))
    return out, results, losses


def test_six_steps_checkpoint_and_evaluate(whole_run):
    out, results, losses = whole_run
    assert sorted(losses) == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(v) for m in losses.values() for v in m.values())
    assert {"loss_rpn_cls", "loss_cls", "total_loss"} <= set(losses[1])
    files = set(os.listdir(out))
    assert {"step_3.pt", "step_6.pt", "best", "best_info.json", "log.txt",
            "metrics.json"} <= files
    bbox = results["bbox"]
    assert all(np.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75", "novel_mean"))
    assert len(bbox["class_AP50"]) == 20 and results["inference_seconds_per_image"] > 0
    payload, _ = checkpoint_tensors(str(out / "step_6.pt"))
    assert payload["step"] == 6 and payload["scheduler"]["last_epoch"] == 6
    assert payload["best_info"]["iteration"] in (3, 6)
    assert "iter" not in open(out / "metrics.json").read()  # period 20: nothing to write yet


@pytest.mark.parametrize("stop_after", [3, 4])  # at a periodic checkpoint, and between two
def test_stop_and_resume_is_bit_identical(whole_run, devkit, tmp_path, monkeypatch, stop_after):
    out_a, results_a, losses_a = whole_run
    out = tmp_path / "run_b"
    results, losses = run_recorded(monkeypatch, cli(devkit, out), stop_after=stop_after)
    assert results is None and sorted(losses) == list(range(1, stop_after + 1))
    assert all(losses[k] == losses_a[k] for k in losses)
    # stopped between two periodic checkpoints: the state was saved on the way out
    assert os.path.exists(out / f"step_{stop_after}.pt")
    assert not os.path.exists(out / "step_6.pt")

    results, losses = run_recorded(monkeypatch, cli(devkit, out, "--resume"))
    assert sorted(losses) == list(range(stop_after + 1, 7))
    assert all(losses[k] == losses_a[k] for k in losses)  # bit-identical floats
    _, want = checkpoint_tensors(str(out_a / "step_6.pt"))
    _, got = checkpoint_tensors(str(out / "step_6.pt"))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert strip_time(results) == strip_time(results_a)


def test_eval_only_equals_the_in_run_evaluation(whole_run, devkit, monkeypatch):
    out, results_a, _ = whole_run
    before = sorted(os.listdir(out))
    results, losses = run_recorded(monkeypatch, cli(devkit, out, "--eval-only", "--resume"))
    assert losses == {} and strip_time(results) == strip_time(results_a)
    assert sorted(os.listdir(out)) == before
    # the best snapshot as MODEL.WEIGHTS: the tolerant merge of one's own checkpoint
    best = read_checkpoint(str(out / "best"))
    results, _ = run_recorded(monkeypatch, cli(
        devkit, out, "--eval-only", opts=["MODEL.WEIGHTS", str(out / "best")]))
    if best["step"] == 6:
        assert strip_time(results) == strip_time(results_a)
    assert np.isfinite(results["bbox"]["AP50"])


def test_fold_bn_at_eval_runs_and_stays_close(whole_run, devkit, monkeypatch):
    out, results_a, _ = whole_run
    results, _ = run_recorded(monkeypatch, cli(
        devkit, out, "--eval-only", "--resume", opts=["TPU.FOLD_BN_AT_EVAL", "True"]))
    # f32: the fold moves one rounding per convolution (tests/test_torch_bn_fold.py)
    assert results["bbox"]["AP50"] == pytest.approx(results_a["bbox"]["AP50"], abs=0.5)


def test_missing_weights_and_device_raise(devkit, tmp_path):
    tdata.DatasetCatalog.clear()
    with pytest.raises(FileNotFoundError, match="MODEL.WEIGHTS"):
        runner.run(cli(devkit, tmp_path, opts=["MODEL.WEIGHTS", "models/none.npz"]),
                   image_loader=seeded_image_loader)
    if not torch.cuda.is_available():
        args = cli(devkit, tmp_path)
        args.device = "cuda"
        tdata.DatasetCatalog.clear()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.run(args, image_loader=seeded_image_loader)


@pytest.mark.parametrize("opts,item", [
    # TTA, PreciseBN and the profile hook are ported (tests/test_torch_tta.py,
    # test_torch_precise_bn.py, test_torch_profiling.py); the cases keep their
    # names and hold TTA with precomputed proposals, FSDP and the uint8 wire;
    # TTA with precomputed proposals is ported since too (the dock recipe's,
    # tests/test_torch_dock_run.py): its case runs (item None), an
    # --eval-only with a proposal file that does not exist (no valid slot)
    pytest.param(["TEST.AUG.ENABLED", "True", "MODEL.LOAD_PROPOSALS", "True",
                  "DATASETS.PROPOSAL_FILES_TEST", "('p.pkl',)",
                  "TEST.AUG.MIN_SIZES", "(64,)", "TEST.AUG.MAX_SIZE", "160",
                  "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "8"], None,
                 id="opts0-item 24"),
    # FSDP and TP are ported (tests/test_torch_fsdp.py, test_torch_tp.py,
    # test_torch_sharded_run.py): TPU.FSDP in one process is the plain run, as
    # unit_tpu ignores FSDP without a mesh (item "trains alone")
    pytest.param(["TPU.FSDP", "True"], "trains alone", id="opts1-item 26"),
    # the uint8 wire is ported (tests/test_torch_host_uint8.py): its case
    # trains on uint8 batches (item "trains") and evaluates
    pytest.param(["TPU.HOST_TRANSFER_UINT8", "True"], "trains", id="opts2-item 31"),
    # data parallelism is ported (tests/test_torch_parallel*.py); FSDP and TP
    # too: TPU.TP 2 in one process refuses, as unit_tpu's assert does
    # (runner.py:222), since 2 does not divide the one rank
    pytest.param(["TPU.TP", "2"], "not divisible by TPU.TP=2", id="opts3-items 27 and 29"),
    # a Res5 head over VGG-CNN-F is ported (tests/test_torch_pairs.py): the
    # case keeps its name and trains and evaluates (item "trains alone")
    pytest.param(["MODEL.BACKBONE.NAME", "VGG_CNN_F"], "trains alone", id="opts4-item 25"),
    # the meta Trainer is ported (tests/test_torch_meta.py); the case keeps
    # its name and holds pipeline parallelism instead, which is ported too
    # (tests/test_torch_pipeline*.py): in one process PP_STAGES 2 does not
    # divide the one rank, and unit_tpu's assert refuses (runner.py:214)
    pytest.param(["TPU.PP", "True"], "divisible by TPU.PP_STAGES=2, got 1",
                 id="opts5-item 23"),
    # PP with TP refuses before anything is built, as unit_tpu's assert does
    pytest.param(["TPU.PP", "True", "TPU.TP", "2"], "does not compose with TPU.TP",
                 id="opts6-PP with TP"),
])
def test_unported_run_options_raise(devkit, tmp_path, opts, item, monkeypatch):
    tdata.DatasetCatalog.clear()
    if item == "trains":  # ported since: the run trains and evaluates
        dtypes = []
        real = StreamLoader._emit

        def emit(self, batch):
            out = real(self, batch)
            dtypes.append(out["image"].dtype)
            return out

        monkeypatch.setattr(StreamLoader, "_emit", emit)
        results, losses = run_recorded(monkeypatch, cli(devkit, tmp_path, opts=opts))
        assert losses and all(np.isfinite(v) for m in losses.values() for v in m.values())
        assert np.isfinite(results["bbox"]["AP50"])
        assert dtypes and set(dtypes) == {np.dtype(np.uint8)}
        return
    if item == "trains alone":  # one process: the plain run trains and evaluates
        results, losses = run_recorded(monkeypatch, cli(devkit, tmp_path, opts=opts))
        assert losses and all(np.isfinite(v) for m in losses.values() for v in m.values())
        assert np.isfinite(results["bbox"]["AP50"])
        return
    if item is not None and item.startswith(("not divisible", "divisible by",
                                             "does not compose")):
        with pytest.raises(ValueError, match=item):
            runner.run(cli(devkit, tmp_path, opts=opts), image_loader=seeded_image_loader)
        return
    if item is None:  # ported since: the run evaluates
        results = runner.run(cli(devkit, tmp_path, "--eval-only", opts=opts),
                             image_loader=seeded_image_loader)
        assert np.isfinite(results["bbox"]["AP"]) and np.isfinite(results["bbox"]["AP50"])
        return
    with pytest.raises(NotImplementedError, match=item):
        runner.run(cli(devkit, tmp_path, opts=opts), image_loader=seeded_image_loader)


def test_more_than_one_device_raises(devkit, tmp_path, monkeypatch):
    """More ranks than cards: refused, naming both counts (unit_tpu scales the
    config for them and clamps its mesh: R15); nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = cli(devkit, tmp_path, "--num-gpus", "4")
    args.device = "cuda"
    with pytest.raises(ValueError, match="--num-gpus 4 asks for 4 cards; 2 present"):
        runner.run(args)


def test_trainer_names_follow_unit_tpu():
    for path in ("configs/VOC/VOC-RCNN-101-C4-split1.yaml",
                 "configs/VOC/VOC-RCNN-101-C4-split1-meta.yaml",
                 "configs/COCO/COCO-RCNN-50-C4-split1-ft.yaml",
                 "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"):
        jcfg, tcfg = jget_cfg(), runner.get_cfg()
        jcfg.merge_from_file(path)
        tcfg.merge_from_file(path)
        assert runner.trainer_name_for(tcfg) == jrunner.trainer_class_for(jcfg).__name__, path
    tcfg = runner.get_cfg()
    tcfg.ENGINE.TRAINER = "NoSuchTrainer"
    with pytest.raises(KeyError, match="unknown ENGINE.TRAINER"):
        runner.trainer_name_for(tcfg)


def test_auto_scale_workers_follows_unit_tpu():
    jcfg, tcfg = jget_cfg(), runner.get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.REFERENCE_WORLD_SIZE = 4
        cfg.SOLVER.IMS_PER_BATCH = 8
        cfg.SOLVER.STEPS = (12000, 24000)
    j, t = jrunner.auto_scale_workers(jcfg, 1), runner.auto_scale_workers(tcfg, 1)
    for key in ("IMS_PER_BATCH", "BASE_LR", "MAX_ITER", "WARMUP_ITERS", "STEPS",
                "CHECKPOINT_PERIOD", "REFERENCE_WORLD_SIZE"):
        assert getattr(t.SOLVER, key) == getattr(j.SOLVER, key), key
    assert t.SOLVER.IMS_PER_BATCH == 2 and t.TEST.EVAL_PERIOD == j.TEST.EVAL_PERIOD
    assert runner.auto_scale_workers(t, 1) is t  # idempotent


# ----------------------------------------------------------- against unit_tpu
def optax_trace(opt_state):
    (trace,) = [s.trace for s in opt_state if hasattr(s, "trace")]
    return jax.tree.map(np.asarray, trace)


def jax_losses(metrics):
    return {k: float(v) for k, v in metrics.items() if k.startswith("loss_") or k == "total_loss"}


def test_first_steps_match_unit_tpus_runner(devkit, tmp_path):
    import unit_tpu.data.loader as jloader

    opts = ["--config-file", FLAGSHIP, *TINY, "DATASETS.CLASSIFIER_DATAROOT", devkit,
            "OUTPUT_DIR", str(tmp_path)]
    jcfg = jget_cfg()
    jcfg.merge_from_file(FLAGSHIP)
    jcfg.merge_from_list(opts[2:])
    jdata.DatasetCatalog.clear()
    jdata.RegisterVOC(jcfg, devkit).register_all()
    seed = jcfg.SEED
    _, _, jtrainer, _ = jrunner.build_everything(jcfg, num_devices=1, seed=seed)
    jtrainer.close()  # its streams would read image files; use the seeded loader
    jtrainer.strong_iter = iter(jloader.build_strong_loader(
        jcfg, seed=seed, image_loader=seeded_image_loader))
    jtrainer.weak_iter = iter(jloader.build_classifier_loader(
        jcfg, seed=seed + 1, image_loader=seeded_image_loader))
    jtrainer.init_state(sample_shape=(1, 96, 160, 3))
    jtrainer.state = jtrainer.state.replace(
        params=randomize_params(jtrainer.state.params, seed=3))
    start = jax.tree.map(np.asarray, jtrainer.state.params)

    def port_trainer(start_step):
        tdata.DatasetCatalog.clear()
        args = cli(devkit, tmp_path)
        cfg = runner.setup(args)
        _, _, trainer = runner.build_everything(
            cfg, torch.device("cpu"), seed=seed, start_step=start_step,
            image_loader=seeded_image_loader)
        trainer.init_state()
        return trainer

    trainer = port_trainer(0)
    try:
        load_jax_train_state(trainer.state, start, optax_trace(jtrainer.state.opt_state), 0)
        for step in (1, 2):
            want = jax_losses(jtrainer.run_step())
            got = trainer.run_step()
            assert set(want) <= set(got)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
        # the momentum both built in two steps
        trace = flatten_tree(optax_trace(jtrainer.state.opt_state))
        opt = trainer.optimizer.optimizer
        n = 0
        for name, p in trainer.model.named_parameters():
            if not p.requires_grad:
                continue
            w = trace[flax_path(name, p)]
            g = to_flax_layout(opt.state[p]["momentum_buffer"].numpy())
            assert np.abs(g - w).max() <= MOMENTUM_REL * np.abs(w).max() + 1e-9, name
            n += 1
        assert n > 20
    finally:
        trainer.close()

    # unit_tpu's whole state at step 2 (parameters, momentum, step) carried over
    resumed = port_trainer(2)
    try:
        load_jax_train_state(resumed.state, jax.tree.map(np.asarray, jtrainer.state.params),
                             optax_trace(jtrainer.state.opt_state), 2)
        assert resumed.state.step == 2 and resumed.optimizer.scheduler.last_epoch == 2
        lr = resumed.optimizer.optimizer.param_groups[0]["lr"]
        assert lr == pytest.approx(0.001 * 1.0, rel=1e-6)  # past the 2 warm-up updates
        want = jax_losses(jtrainer.run_step())
        got = resumed.run_step()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step 3 {k}")
    finally:
        resumed.close()
