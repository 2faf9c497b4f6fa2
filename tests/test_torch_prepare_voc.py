"""scripts/prepare_voc_torch.py against scripts/prepare_voc.py, on a synthetic devkit.

Both write the seeded k-shot split files of VOC2007 + VOC2012 trainval
(``--skip-download``: nothing is fetched here), the original through
unit_tpu.data.voc, the twin through unit_tpu_torch.data.voc, on a
two-year devkit from tests/test_torch_data.py::write_devkit (24 images a
year, 1-3 objects each):

  * for shots 1, 2, 3, 5, 10 and seeds 0 and 1 the twin's CLI writes the
    original's files, ``vocsplit/kshot_{K}_seed{S}.json``, byte for byte;
  * R20, kept for parity: that layout is not the one either package's
    ``load_kshot_split_files`` reads (``box_{K}shot_{cls}_train.txt``), so
    on the twin's output directory both return None (their loaders then
    sample with ``kshot_sample``).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

import unit_tpu.data.voc as jvoc
import unit_tpu_torch.data.voc as tvoc
from tests.test_torch_data import write_devkit

REPO = Path(__file__).resolve().parent.parent
SHOTS, SEEDS = (1, 2, 3, 5, 10), (0, 1)


def original():
    spec = importlib.util.spec_from_file_location("prepare_voc",
                                                  REPO / "scripts" / "prepare_voc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    devkit = write_devkit(root / "VOCdevkit", n_images=24, seed=3)
    want = root / "reference_split"
    original().write_kshot_splits(devkit, str(want), SHOTS, SEEDS)
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "prepare_voc_torch.py"), "--data-root",
         str(root), "--skip-download", "--shots", *map(str, SHOTS), "--seeds", *map(str, SEEDS)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return devkit, want, root / "vocsplit"


def test_split_files_are_byte_identical(splits):
    _, want, got = splits
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(f"kshot_{k}_seed{s}.json" for k in SHOTS for s in SEEDS)
    assert sorted(p.name for p in got.iterdir()) == names
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    assert (got / "kshot_10_seed0.json").read_bytes() != (got / "kshot_1_seed0.json").read_bytes()


def test_neither_loader_reads_the_written_layout(splits):
    """R20: the loaders look for box_{K}shot_{cls}_train.txt in the same
    vocsplit directory, find none, and return None."""
    devkit, _, got = splits
    for voc in (jvoc, tvoc):
        for shots in SHOTS:
            assert voc.load_kshot_split_files(str(got), shots, tvoc.VOC_CLASSES, devkit) is None
