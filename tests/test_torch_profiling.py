"""The profiler hooks of unit_tpu_torch (torch.profiler): twins of
tests/test_profiling.py's three, and the hook inside the run loop
(TPU.PROFILE_START_STEP), on the CPU."""

import glob
import json
import os

import numpy as np
import torch

import unit_tpu_torch.data as tdata
from tests.test_torch_data import seeded_image_loader, write_devkit
from tests.test_torch_runner import TINY, FLAGSHIP
from unit_tpu_torch.engine import runner
from unit_tpu_torch.utils.profiling import ProfileHook, trace


def _traced_files(logdir):
    return glob.glob(os.path.join(logdir, "*.pt.trace.json"))


def _work():
    x = torch.ones(8, 8)
    return (x @ x).sum()


def test_trace_context_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        _work()
    files = _traced_files(logdir)
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


def test_profile_hook_window(tmp_path):
    logdir = str(tmp_path / "hook")
    hook = ProfileHook(logdir, start=2, num_steps=2)
    active = []
    for step in range(6):
        _work()
        hook(step, {}, trainer=None)
        active.append(hook._active)
    assert active == [False, False, True, True, False, False]
    assert _traced_files(logdir) == [hook.path], "hook wrote no profile artifacts"


def test_profile_hook_close_mid_window(tmp_path):
    """Training ending inside the trace window must still finalize the trace
    (run() calls close() in its finally)."""
    logdir = str(tmp_path / "cut")
    hook = ProfileHook(logdir, start=1, num_steps=100)
    for step in range(3):  # ends long before start + num_steps
        _work()
        hook(step, {}, trainer=None)
    assert hook._active and not _traced_files(logdir)
    hook.close()
    assert not hook._active
    assert _traced_files(logdir), "close() did not finalize the trace"
    hook.close()  # idempotent
    assert len(_traced_files(logdir)) == 1


def test_run_writes_a_trace_under_output_dir(tmp_path):
    devkit = write_devkit(tmp_path / "VOCdevkit", n_images=2)
    out = tmp_path / "out"
    args = runner.default_argument_parser().parse_args([
        "--config-file", FLAGSHIP, "--device", "cpu", "--data-root", devkit, *TINY,
        "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(out),
        "SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
        "TPU.PROFILE_START_STEP", "2", "TPU.PROFILE_NUM_STEPS", "5"])
    tdata.DatasetCatalog.clear()
    results = runner.run(args, image_loader=seeded_image_loader)
    assert np.isfinite(results["bbox"]["AP50"])
    # the window (steps 3-7) outlives the run's 3 steps: run() closed it
    files = _traced_files(str(out / "trace"))
    assert len(files) == 1
    names = {str(e.get("name")) for e in json.load(open(files[0]))["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
