"""The soak twin's verifier against unit_tpu's, on synthetic run directories.

scripts/verify_soak.py reads a unit_tpu soak's OUTPUT_DIR, whose periodic
checkpoints are orbax's numeric step directories; the port writes
``step_<N>.pt`` files, so scripts/verify_soak_torch.py counts those.  Each
case writes two run directories that differ only in that layout (the same
metrics.json, stage2.log with its "resuming from step" line, best_info.json
and best/) and runs each verifier on its own: the verdict, the exit code and
every line they print must agree (the one message that names the layout
reads "step files" in the twin where the original says "step dirs").  The
cases: a run that passes, a gap in the logged iterations, a loss jump at the
resume, an LR that does not drop at a step, one checkpoint too many, and no
best_info.json.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ITERS, STEPS, RESUME = 4000, (1600, 3200), 2000
CASES = {  # case -> expected verdict
    "pass": True, "gap": False, "loss_jump": False, "no_lr_drop": False,
    "too_many_checkpoints": False, "no_best_info": False,
}


def records(case):
    """metrics.json's lines: every 20 steps to the preemption just past
    RESUME, then again from RESUME + 20 (the resumed run) to ITERS."""
    its = list(range(20, RESUME + 60, 20)) + list(range(RESUME + 20, ITERS + 20, 20))
    if case == "gap":
        its = [i for i in its if not 2600 <= i <= 2800]
    out = []
    for i in its:
        lr = 0.004 * 0.1 ** sum(i >= s for s in STEPS)
        if case == "no_lr_drop" and i >= STEPS[1]:
            lr = 0.0004
        loss = 0.3 + 2.0 * math.exp(-i / 3000)
        if case == "loss_jump" and RESUME <= i < RESUME + 400:
            loss *= 3
        out.append({"iteration": i, "total_loss": loss, "lr": lr, "data_time": 0.01})
    return out


def write_run(root, case, layout):
    """A soak's runs dir under ``root``: ``soak/`` (OUTPUT_DIR) and the stage
    logs; checkpoints as orbax step dirs or the port's step files."""
    out = root / "soak"
    out.mkdir(parents=True)
    with open(out / "metrics.json", "w") as f:
        for rec in records(case):
            f.write(json.dumps(rec) + "\n")
    (root / "stage2.log").write_text(f"[runner] resuming from step {RESUME}\n")
    (out / "log.txt").write_text(f"resuming from step {RESUME}\n")
    kept = (2500, 3000, 3500, 4000) if case == "too_many_checkpoints" else (3000, 3500, 4000)
    for step in kept:
        if layout == "orbax":
            (out / str(step) / "default").mkdir(parents=True)
        else:
            (out / f"step_{step}.pt").write_bytes(b"payload")
    if case != "no_best_info":
        (out / "best_info.json").write_text(json.dumps({"AP50": 51.5, "iteration": 3500}))
    (out / "best").mkdir()
    (out / "best" / ("model" if layout == "orbax" else "model.pt")).write_bytes(b"best")
    return out


def verify(script, outdir):
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / script), str(outdir), "--iters", str(ITERS),
         "--steps", *map(str, STEPS)], capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout.splitlines()


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_gives_the_originals_verdict(tmp_path, case):
    rc, lines = verify("verify_soak.py", write_run(tmp_path / "orbax", case, "orbax"))
    rc_t, lines_t = verify("verify_soak_torch.py", write_run(tmp_path / "torch", case, "torch"))
    assert lines[-1] == lines_t[-1] == ("SOAK PASS" if CASES[case] else "SOAK FAIL"), lines_t
    assert rc == rc_t == (0 if CASES[case] else 1)
    assert [ln.replace("step dirs", "step files") for ln in lines] == lines_t
    assert any("checkpoints kept" in ln for ln in lines_t)


def test_twin_counts_step_files_not_directories(tmp_path):
    """On the port's layout the original finds no checkpoint at all (its
    check 4), which is why the twin exists; the twin fails an orbax one."""
    torch_run = write_run(tmp_path / "torch", "pass", "torch")
    orbax_run = write_run(tmp_path / "orbax", "pass", "orbax")
    rc, lines = verify("verify_soak.py", torch_run)
    assert rc == 1 and "FAIL: no checkpoint step dirs found" in lines
    rc, lines = verify("verify_soak_torch.py", orbax_run)
    assert rc == 1 and "FAIL: no checkpoint step files found" in lines
    assert os.path.isdir(orbax_run / "3000")
