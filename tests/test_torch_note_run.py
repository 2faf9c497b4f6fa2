"""The note recipe through the run loop and the data pipeline: unit_tpu_torch
vs unit_tpu on a shapes-COCO devkit.

configs/COCO/COCO-RCNN-50-C4-split1-note.yaml (InceptionResNetV2 +
InceptionResNetHead, tests/test_torch_note.py) at full depth on
tests/test_torch_runner.py's tiny sizes (a 96-pixel short side), with 4 RPN
proposals an image in training and the ROI batch at those 4 + 4 GT slots, so
that every candidate is sampled in both packages (the keep-everything regime
of tests/test_torch_losses.py): the 17x17 head costs ~2 GMAC a ROI.  Also the two keys of the recipe that unit_tpu
reads nowhere, held as reference faults R10 and R11 (ROADMAP Queue 3): the
port reads them nowhere either.

Bounds: the runner's first two steps' losses to rtol 1e-4
(tests/test_torch_runner.py's bound); batches bit-identical.
"""

import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu.data.loader as jloader
import unit_tpu_torch.data as tdata
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import seeded_image_loader
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from tests.test_torch_runner import TINY, jax_losses, optax_trace
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.data.utils import register_datasets as jregister_datasets
from unit_tpu.engine import runner as jrunner
from unit_tpu.engine import train as jtrain
from unit_tpu.solver.build import is_frozen as jis_frozen
from unit_tpu_torch.checkpoint import load_jax_train_state, read_checkpoint
from unit_tpu_torch.checkpoint.jax_params import flax_path
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data.transforms import load_image_bgr
from unit_tpu_torch.data.utils import register_datasets
from unit_tpu_torch.engine import TrainerNoMeta, runner
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

NOTE = "configs/COCO/COCO-RCNN-50-C4-split1-note.yaml"
RUN = [*TINY, "MODEL.RPN.POST_NMS_TOPK_TRAIN", "4", "MODEL.RPN.POST_NMS_TOPK_TEST", "8",
       "TPU.MAX_GT_BOXES", "4", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "8",
       "INPUT.MIN_SIZE_TRAIN", "(96,)"]
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes_coco"))
    runpy.run_path("scripts/make_shapes_coco_torch.py")["write_shapes_coco"](
        root, train_images=8, val_images=4, size=96, seed=7)
    return root


def cli(devkit, out, *flags, opts=()):
    return runner.default_argument_parser().parse_args(
        ["--config-file", NOTE, "--device", "cpu", "--data-root", devkit, *flags, *RUN,
         "OUTPUT_DIR", str(out), *opts])


def shapes_only(create_train_state):
    """unit_tpu's create_train_state as shapes (jax.eval_shape): its jitted
    init of the whole note model compiles for ~30 s on the CPU, and the
    runner reads only the template's tree from it."""
    return lambda *a, **kw: jax.eval_shape(lambda: create_train_state(*a, **kw))


def test_first_steps_match_unit_tpus_runner(devkit, tmp_path, monkeypatch):
    """unit_tpu's runner and the port's take the same two steps from one
    seeded flax tree and momentum.  unit_tpu's state is made from the
    shapes (``shapes_only``): randomize_params replaces its parameters
    anyway, and optax's init of them is its momentum trace of zeros."""
    jcfg = jget_cfg()
    jcfg.merge_from_file(NOTE)
    jcfg.merge_from_list([*RUN, "DATASETS.CLASSIFIER_DATAROOT", devkit,
                          "OUTPUT_DIR", str(tmp_path / "jax")])
    jdata.DatasetCatalog.clear()
    jregister_datasets(jcfg, devkit)
    seed = jcfg.SEED
    monkeypatch.setattr(jtrain, "create_train_state", shapes_only(jtrain.create_train_state))
    _, _, jtrainer, _ = jrunner.build_everything(jcfg, num_devices=1, seed=seed)
    jtrainer.close()  # its streams would read the JPEGs; use the seeded loader
    jtrainer.strong_iter = iter(jloader.build_strong_loader(
        jcfg, seed=seed, image_loader=seeded_image_loader))
    jtrainer.weak_iter = iter(jloader.build_classifier_loader(
        jcfg, seed=seed + 1, image_loader=seeded_image_loader))
    params = randomize_params(jtrainer.init_state(sample_shape=(1, 96, 160, 3)).params, seed=3)
    jtrainer.state = jtrain.TrainState(params=params, opt_state=jtrainer.optimizer.init(params),
                                       step=jnp.zeros((), jnp.int32))
    tdata.DatasetCatalog.clear()
    cfg = runner.setup(cli(devkit, tmp_path / "port"))
    _, _, trainer = runner.build_everything(cfg, torch.device("cpu"), seed=seed,
                                            image_loader=seeded_image_loader)
    try:
        assert isinstance(trainer, TrainerNoMeta)
        trainer.init_state()
        load_jax_train_state(trainer.state, jax.tree.map(np.asarray, jtrainer.state.params),
                             optax_trace(jtrainer.state.opt_state), 0)
        for step in (1, 2):
            want = jax_losses(jtrainer.run_step())
            got = trainer.run_step()
            assert {"loss_cls", "loss_oicr_3", "loss_rpn_cls"} <= set(want) <= set(got)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
    finally:
        trainer.close()


class Recording(TrainerNoMeta):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        Recording.made.append(self)


def test_run_trains_evaluates_and_resumes(devkit, tmp_path, monkeypatch):
    """The port's runner on the note recipe: two steps, a checkpoint and a
    COCO bbox evaluation at 2; then ``--resume`` takes step 3 from it."""
    monkeypatch.setattr(runner, "TrainerNoMeta", Recording)
    out = tmp_path / "note"
    Recording.made = []
    tdata.DatasetCatalog.clear()
    results = runner.run(cli(devkit, out, opts=["SOLVER.MAX_ITER", "2",
                                                "SOLVER.CHECKPOINT_PERIOD", "2",
                                                "TEST.EVAL_PERIOD", "2"]))
    bbox = results["bbox"]
    assert all(np.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75", "novel_mean"))
    (trainer,) = Recording.made
    assert len(trainer.metrics_history) == 2
    assert all(np.isfinite(v) for m in trainer.metrics_history for v in m.values())
    assert type(trainer.model.backbone).__name__ == "InceptionResNetV2"
    payload = read_checkpoint(str(out / "step_2.pt"))
    assert payload["step"] == 2 and any(k.startswith("backbone.block17_19.") for k in
                                        payload["model"])
    tdata.DatasetCatalog.clear()
    runner.run(cli(devkit, out, "--resume", opts=["SOLVER.MAX_ITER", "3",
                                                  "SOLVER.CHECKPOINT_PERIOD", "3",
                                                  "TEST.EVAL_PERIOD", "100"]))
    resumed = Recording.made[-1]
    assert resumed.state.step == 3 and len(resumed.metrics_history) == 1
    assert (out / "step_3.pt").is_file()


def test_train_net_script_runs_on_the_card_unless_asked_for_the_cpu(devkit, tmp_path,
                                                                    monkeypatch):
    if torch.cuda.is_available():
        return  # the card's machine runs the note recipe in chip_smoke.py phase 16
    tdata.DatasetCatalog.clear()
    monkeypatch.setattr("sys.argv", ["train_net_torch.py", "--config-file", NOTE,
                                     "--data-root", devkit, *RUN, "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device.*--device cpu"):
        runpy.run_path("scripts/train_net_torch.py", run_name="__main__")


# ------------------------------------------------- keys unit_tpu never reads
def note_cfgs(devkit, *opts):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(NOTE)
        cfg.merge_from_list([*RUN, "DATASETS.CLASSIFIER_DATAROOT", devkit, *opts])
    return jcfg, tcfg


def test_input_format_rgb_is_read_by_neither_package(devkit):
    """R10: the note recipe sets INPUT.FORMAT "RGB" (its PIXEL_MEAN and
    PIXEL_STD are 0.5 on [0, 1] images, symmetric in the channels), but
    unit_tpu reads the key nowhere and loads every image BGR.  The port keeps
    that: the strong stream's batches of the recipe's files are the same
    under "RGB" and "BGR", in both packages, and hold the files' pixels in
    BGR order."""
    batches = {}
    for fmt in ("RGB", "BGR"):
        jcfg, tcfg = note_cfgs(devkit, "INPUT.FORMAT", fmt)
        tdata.DatasetCatalog.clear()
        jdata.DatasetCatalog.clear()
        register_datasets(tcfg, devkit)
        jregister_datasets(jcfg, devkit)
        batches[fmt] = (next(iter(tdata.build_strong_loader(tcfg, seed=3))),
                        next(iter(jdata.build_strong_loader(jcfg, seed=3))))
    assert get_cfg().INPUT.FORMAT == "BGR" and note_cfgs(devkit)[1].INPUT.FORMAT == "RGB"
    (t_rgb, j_rgb), (t_bgr, j_bgr) = batches["RGB"], batches["BGR"]
    for got in (t_bgr, j_rgb, j_bgr):
        for k in t_rgb:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(t_rgb[k]), err_msg=k)
    from PIL import Image

    path = os.path.join(devkit, "train2017", sorted(os.listdir(
        os.path.join(devkit, "train2017")))[0])
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.float32)
    np.testing.assert_array_equal(load_image_bgr(path), rgb[..., ::-1])


def test_freeze_convs_freezes_nothing_in_either_package(devkit):
    """R11: MODEL.BACKBONE.FREEZE_CONVS 2 (the note recipe's) is read by
    neither package: every backbone parameter trains, as at 0, and the
    frozen sets are the same leaf by leaf."""
    frozen = {}
    for n in ("2", "0"):
        jcfg, tcfg = note_cfgs(devkit, "MODEL.BACKBONE.FREEZE_CONVS", n)
        with torch.device("meta"):  # the parameters' names are enough
            model = WSRCNN(ModelConfig.from_cfg(tcfg))
        build_optimizer(tcfg, model)
        frozen[n] = {name for name, p in model.named_parameters() if not p.requires_grad}
        for name, p in model.named_parameters():
            assert p.requires_grad == (not jis_frozen(flax_path(name, p), jcfg)), name
        assert all(p.requires_grad for p in model.backbone.parameters())
    assert frozen["2"] == frozen["0"] == set()
    assert note_cfgs(devkit)[1].MODEL.BACKBONE.FREEZE_CONVS == 2
