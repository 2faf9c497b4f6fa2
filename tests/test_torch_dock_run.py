"""The dock recipe through the port's run loop on a shapes-COCO devkit with
precomputed proposals.

configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml at full width (VGG-CNN-F, the
4096-wide fc head, 80 classes) on tiny inputs (a 96-pixel short side),
DATASETS.PROPOSAL_FILES_{TRAIN,CLASSIFIER_TRAIN,TEST} from
scripts/make_shapes_proposals_torch.py (40 proposals an image in training,
20 at test): ``engine.runner.run`` takes two steps without the RPN, writes a
checkpoint at each and evaluates at 2 from the files' proposals; a
``--resume`` from step 1 takes step 2 again with the same losses, bit for
bit: the same dropout masks from the same step seed.  ``--eval-only`` with
TEST.AUG.ENABLED scores the files' proposals in every variant, and never
calls the RPN.  The YAML alone (no file) trains the RPN on the strong
stream, with R12's all-invalid weak slots.  Against unit_tpu the recipe is
held in tests/test_torch_dock_slice.py (its run loop's dropout masks are
threefry's, so its losses cannot be compared step for step).
"""

import os
import runpy

import numpy as np
import pytest

import unit_tpu_torch.data as tdata
from tests.test_torch_data import seeded_image_loader
from tests.test_torch_dock_data import link_2014
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu_torch.engine import TrainerNoMeta, runner
from unit_tpu_torch.models import WSRCNN

DOCK = "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"
RUN = [
    "MODEL.WEIGHTS", "", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "200", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "INPUT.MIN_SIZE_TRAIN", "(80, 96)", "INPUT.MAX_SIZE_TRAIN", "160",
    "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
    "TEST.AUG.MIN_SIZES", "(80, 112)", "TEST.AUG.MAX_SIZE", "192",
    "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", "40",
    "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "20",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "2",
    "TPU.MAX_GT_BOXES", "10", "TPU.COMPUTE_DTYPE", "float32", "SEED", "5",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
]


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes_coco_dock_run"))
    runpy.run_path("scripts/make_shapes_coco_torch.py")["write_shapes_coco"](
        root, train_images=8, val_images=3, size=96, seed=7)
    link_2014(root)
    runpy.run_path("scripts/make_shapes_proposals_torch.py")["write_proposals"](
        root, ("train2014", "val2014"), per_image=60, seed=11)
    return root


def files(devkit):
    train = f"('{os.path.join(devkit, 'proposals_train2014.pkl')}',)"
    return ["DATASETS.PROPOSAL_FILES_TRAIN", train,
            "DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN", train,
            "DATASETS.PROPOSAL_FILES_TEST", f"('{os.path.join(devkit, 'proposals_val2014.pkl')}',)"]


def run(devkit, out, *flags, opts=()):
    tdata.DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args(
        ["--config-file", DOCK, "--device", "cpu", "--data-root", devkit, *flags, *RUN,
         "OUTPUT_DIR", str(out), *opts])
    return runner.run(args, image_loader=seeded_image_loader)


class Recording(TrainerNoMeta):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        Recording.made.append(self)


def no_rpn(*a, **kw):
    raise AssertionError("the RPN proposed on a path with precomputed proposals")


def test_run_trains_evaluates_and_resumes_from_proposal_files(devkit, tmp_path, monkeypatch):
    monkeypatch.setattr(runner, "TrainerNoMeta", Recording)
    monkeypatch.setattr(WSRCNN, "_train_proposals", no_rpn)
    monkeypatch.setattr(WSRCNN, "_test_proposals", no_rpn)
    Recording.made = []
    out = tmp_path / "dock"
    opts = files(devkit) + ["SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
                            "TEST.EVAL_PERIOD", "2"]
    results = run(devkit, out, opts=opts)
    assert all(np.isfinite(results["bbox"][k]) for k in ("AP", "AP50", "novel_mean"))
    (trainer,) = Recording.made
    assert trainer.dropout and len(trainer.metrics_history) == 2
    for m in trainer.metrics_history:
        assert "loss_cls" in m and "loss_oicr_3" in m and not any(k.startswith("loss_rpn")
                                                                  for k in m)
        assert all(np.isfinite(v) for v in m.values())
    assert (out / "step_1.pt").is_file() and (out / "step_2.pt").is_file()
    # a resume from step 1 takes the same step 2: the same batches, the same
    # sampling and the same dropout masks
    resumed_dir = tmp_path / "resumed"
    os.makedirs(resumed_dir)
    os.link(out / "step_1.pt", resumed_dir / "step_1.pt")
    run(devkit, resumed_dir, "--resume", opts=opts[:-2] + ["TEST.EVAL_PERIOD", "100"])
    again = Recording.made[-1]
    assert again.state.step == 2 and len(again.metrics_history) == 1
    want = {k: v for k, v in trainer.metrics_history[1].items() if k != "data_time"}
    got = {k: v for k, v in again.metrics_history[0].items() if k != "data_time"}
    assert got == want


def test_eval_only_with_tta_scores_the_files_proposals(devkit, tmp_path, monkeypatch):
    calls = []
    real = WSRCNN.predict_tta

    def recording(self, *a, **kw):
        calls.append(kw.get("proposal_boxes"))
        return real(self, *a, **kw)

    monkeypatch.setattr(WSRCNN, "predict_tta", recording)
    monkeypatch.setattr(WSRCNN, "_test_proposals", no_rpn)
    results = run(devkit, tmp_path / "tta", "--eval-only",
                  opts=files(devkit) + ["TEST.AUG.ENABLED", "True"])
    assert np.isfinite(results["bbox"]["AP"])
    assert len(calls) == 3 and all(c is not None and tuple(c.shape) == (1, 20, 4)
                                   for c in calls)


def test_the_yaml_alone_trains_the_rpn_beside_empty_weak_slots(devkit, tmp_path, monkeypatch):
    """No proposal file: the strong stream and the evaluation fall back to
    the RPN; the weak stream keeps its invalid slots (R12), so its losses
    carry no gradient but stay finite."""
    monkeypatch.setattr(runner, "TrainerNoMeta", Recording)
    Recording.made = []
    results = run(devkit, tmp_path / "yaml", opts=["SOLVER.MAX_ITER", "1",
                                                   "SOLVER.CHECKPOINT_PERIOD", "100",
                                                   "TEST.EVAL_PERIOD", "1"])
    (trainer,) = Recording.made
    (m,) = trainer.metrics_history
    assert {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_im_cls"} <= set(m)
    assert all(np.isfinite(v) for v in m.values())
    assert np.isfinite(results["bbox"]["AP"])
