"""Each cell's harness end to end on the CPU at a tiny size: set-up, the
window, the traced window, the reference and the result line as the
contract has it (``run.make_result``), with the program (its plain
kernels) and the reference agreeing to float32 rounding, and the loader's
batches equal to those the reference makes from the dataset's files."""

import json
import os
import subprocess
import sys

import pytest

import bench_testlib as lib

CELLS = ["voc-r101-c4.train", "coco-r50-c4-segm.train"]
DRIVER = """
import json, sys, time
sys.path[:0] = {paths!r}
import bench_testlib as lib
import run
from harness import common
cell = lib.tiny_cell({name!r})
from harness import train
out = train.run(cell, {seed}, 2.0, {trace}, time.perf_counter(), device="cpu")
print("FORBIDDEN", json.dumps(common.forbidden_modules()))
print(json.dumps(run.make_result(cell, out, {trace})))
"""


def drive(name: str, trace: bool, seed: int, tmp_path):
    """A fresh interpreter runs the cell: its result line and what it
    imported."""
    code = DRIVER.format(paths=[os.path.dirname(__file__), lib.BENCH, lib.ROOT], name=name,
                         seed=seed, trace=trace)
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=lib.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2].split(" ", 1)[1]), json.loads(lines[-1]), proc.stderr


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(name, trace, tmp_path):
    forbidden, result, err = drive(name, trace, 2**31 + 17, tmp_path)
    assert forbidden == []
    assert list(result) == (["correct", "attempted", "failed", "metrics", "device"]
                            + (["breakdown"] if trace else []) + ["checks"])
    assert result["correct"] is True, result["checks"]
    assert all(v["value"] <= (0 if k.startswith("loader.") else 1e-6)
               for k, v in result["checks"].items()), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"setup_s", "train_img_s"}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    # the run's data and trace went under TMPDIR and are gone
    assert os.listdir(tmp_path) == []
