"""What the benchmark imports: no module whose top-level name (the part
before the first dot, compared whole: ``unit_tpu_torch`` is not
``unit_tpu``) is jax, jaxlib, flax or the JAX package, in any file of the
harness; nothing of the program in the reference; and, run in a fresh
interpreter, the reference loads neither."""

import ast
import os
import subprocess
import sys

import bench_testlib as lib

FORBIDDEN = {"jax", "jaxlib", "flax", "unit_tpu"}


def top_level_imports(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for root, _, files in os.walk(os.path.join(lib.BENCH, sub)):
        if os.sep + "tests" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere_in_the_harness():
    found = {(os.path.relpath(p, lib.BENCH), m) for p in sources()
             for m in top_level_imports(p) if m in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(os.path.relpath(p, lib.BENCH), m) for p in sources("reference")
             for m in top_level_imports(p) if m in FORBIDDEN | {"unit_tpu_torch"}}
    assert not found


def test_reference_runs_without_the_program(tmp_path):
    code = f"""
import sys
sys.path[:0] = {[lib.BENCH, os.path.join(lib.BENCH, "reference")]!r}
import numpy as np, torch
from harness import common
cell = common.Cell(common.load_json({lib.ROOT!r}, "BENCHMARK.json"), "coco-r50-c4-segm.train")
cell.config["changed"].update({lib.TINY!r})
ref = cell.reference
r = ref.Recipe(cell.config)
state = ref.make_state(r, 3, torch.device("cpu"), np.zeros((80, 300), np.float32))
ref.calibrate(r, state, torch.rand(1, 60, 80, 3) * 255)
g = torch.Generator().manual_seed(0)
def batch(strong):
    b = {{"image": torch.rand(2, 96, 128, 3, generator=g) * 255,
          "image_size": torch.tensor([[60.0, 80.0], [60.0, 80.0]])}}
    if strong:
        b.update(gt_boxes=torch.tensor([[[4.0, 5.0, 40.0, 50.0]] * 8] * 2),
                 gt_classes=torch.full((2, 8), 7), gt_valid=torch.arange(8).expand(2, 8) < 1,
                 gt_masks=torch.ones(2, 8, 28, 28))
    else:
        b["labels"] = torch.zeros(2, 80).index_fill_(1, torch.tensor([7]), 1.0)
    return b
out = ref.train(r, state, [(batch(True), batch(False))], 5)
assert all(np.isfinite(v) for v in out["losses"][0].values()), out["losses"]
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN | {"unit_tpu_torch"})!r})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
