"""shapes-VOC and the accuracy pipeline of unit_tpu_torch, on the CPU.

scripts/make_shapes_voc_torch.py must write the same files as
scripts/make_shapes_voc.py at one seed (every JPEG, XML and split file, byte
for byte); on that tree the port's VOC registration and its strong and
classifier loaders (JPEGs decoded from disk) must give what unit_tpu's give,
with both packages on their C loaders and with both on PIL.
scripts/run_shapes_pipeline_torch.sh then runs its three stages through the
port's CLIs at a tiny size (depth 26, RES2_OUT_CHANNELS 16, 64x96 inputs, a
few steps a stage, 2 images a class) with ``CLI_ARGS="--device cpu"``.
"""

import filecmp
import os
import runpy
import subprocess
from pathlib import Path

import pytest

import unit_tpu.data as jdata
import unit_tpu.data.native as jnative_mod
import unit_tpu_torch.data as tdata
from tests.test_torch_data import assert_same_batch, data_cfg
from tests.test_torch_native import count_calls, jnative, tnative  # noqa: F401  (fixtures)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data import native

REPO = Path(__file__).resolve().parent.parent
SHAPES = runpy.run_path(str(REPO / "scripts" / "make_shapes_voc_torch.py"))
# two intra-op threads a CLI process, as tests/test_torch_note.py::two_threads
# holds the test processes: the suite runs its files in parallel workers
THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
ARGS = dict(train_per_class=2, test_per_class=1, size=96, seed=5)


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes_voc"))
    assert SHAPES["write_shapes_voc"](root, **ARGS) == (20, 10)
    return root


def all_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_the_twin_script_writes_the_same_devkit(devkit, tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "make_shapes_voc.py", "--root", str(tmp_path), "--train-per-class", "2",
        "--test-per-class", "1", "--size", "96", "--seed", "5"])
    runpy.run_path(str(REPO / "scripts" / "make_shapes_voc.py"), run_name="__main__")
    names = all_files(devkit)
    assert names == all_files(tmp_path)
    assert sum(n.endswith(".jpg") for n in names) == 50
    assert sum(n.endswith(".xml") for n in names) == 50
    assert sum(n.endswith(".txt") for n in names) == 3
    match, mismatch, errors = filecmp.cmpfiles(devkit, tmp_path, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


@pytest.fixture
def both(devkit):
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    tcfg, jcfg = data_cfg(get_cfg, devkit), data_cfg(jget_cfg, devkit)
    tdata.RegisterVOC(tcfg, devkit).register_all()
    jdata.RegisterVOC(jcfg, devkit).register_all()
    return tcfg, jcfg


@pytest.mark.parametrize("path", ["native", "pil"])
def test_the_port_reads_the_devkit_as_unit_tpu_does(both, path, request, monkeypatch):
    """Both packages on their C loaders, or both on PIL and numpy: each pair
    gives the same batches (the C resize is f32, the numpy one f64, so the
    two paths differ from each other).  The path is pinned, not left to
    whether unit_tpu's native/libunit_native.so happens to be built."""
    tcfg, jcfg = both
    if path == "native":
        request.getfixturevalue("tnative")
        request.getfixturevalue("jnative")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative_mod, "_LIB_PATHS", [])
        monkeypatch.setattr(jnative_mod, "_LIB", None)
    calls = (count_calls(monkeypatch, native, "prepare_image_native"),
             count_calls(monkeypatch, jnative_mod, "prepare_image_native"))
    for name in ("voc_base_training_query_train", "voc_base_training_query_val",
                 "pascal_trainval_2007", "pascal_trainval_2012"):
        got, want = tdata.DatasetCatalog.get(name), jdata.DatasetCatalog.get(name)
        assert got == want and len(got) > 0, name
    boxes = 0
    for build in ("build_strong_loader", "build_classifier_loader"):
        tit = iter(getattr(tdata, build)(tcfg, seed=3))
        jit = iter(getattr(jdata, build)(jcfg, seed=3))
        for _ in range(3):  # JPEGs decoded from the files, resized to the canvas
            got, want = next(tit), next(jit)
            assert_same_batch(got, want)
            boxes += int(got.get("gt_valid", got.get("labels")).sum())
    assert boxes > 0
    assert calls[0]["n"] == calls[1]["n"] and (calls[0]["n"] > 0) == (path == "native")


def test_the_pipeline_runs_its_three_stages_on_the_cpu(devkit, tmp_path):
    runs = tmp_path / "runs"
    tiny = ("MODEL.RESNETS.DEPTH 26 MODEL.RESNETS.RES2_OUT_CHANNELS 16 "
            "INPUT.MIN_SIZE_TRAIN (64,) INPUT.MAX_SIZE_TRAIN 96 INPUT.MIN_SIZE_TEST 64 "
            "INPUT.MAX_SIZE_TEST 96 SOLVER.MAX_ITER 4 SOLVER.CHECKPOINT_PERIOD 2 "
            "TEST.EVAL_PERIOD 4 MODEL.RPN.PRE_NMS_TOPK_TRAIN 200 "
            "MODEL.RPN.POST_NMS_TOPK_TRAIN 50 MODEL.RPN.PRE_NMS_TOPK_TEST 100 "
            "MODEL.RPN.POST_NMS_TOPK_TEST 30 MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE 32")
    env = dict(os.environ, **THREADS, ITERS="4", CLI_ARGS="--device cpu", EXTRA_OPTS=tiny)
    run = subprocess.run(["bash", str(REPO / "scripts" / "run_shapes_pipeline_torch.sh"),
                          devkit, str(runs)], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, (run.stdout[-3000:], run.stderr[-3000:])
    assert "=== pipeline done ===" in run.stdout
    for stage in ("shapes_base", "shapes_base_eval", "shapes_ft10"):
        log = (runs / f"{stage}.log").read_text()
        assert "csv: bbox,AP50," in log and "csv: bbox,novel_mean," in log, stage
    assert (runs / "shapes_base" / "best" / "model.pt").exists()
    assert "warm-started" in (runs / "shapes_base_eval.log").read_text()
    assert "warm-started" in (runs / "shapes_ft10.log").read_text()
    assert (runs / "shapes_ft10" / "step_4.pt").exists()  # the fine-tune took its steps


def test_a_failing_stage_stops_the_pipeline(devkit, tmp_path):
    """``set -o pipefail``: a stage that fails behind ``| tee`` ends the run."""
    env = dict(os.environ, **THREADS, ITERS="4", CLI_ARGS="--device cpu",
               EXTRA_OPTS="MODEL.NO_SUCH_KEY 1")
    run = subprocess.run(["bash", str(REPO / "scripts" / "run_shapes_pipeline_torch.sh"),
                          devkit, str(tmp_path / "runs")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0
    assert "[2/3]" not in run.stdout
