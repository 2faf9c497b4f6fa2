"""unit_tpu_torch imports and runs without jax.

The check runs in a subprocess: this test process has already imported jax
(tests/conftest.py).  A source scan adds what an import cannot show: no
library kernel, no torch.compile, and no import of unit_tpu beyond its
jax-free config package.
"""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "unit_tpu_torch"

_RUN_WITHOUT_JAX = r"""
import importlib, pkgutil, sys
import torch
import unit_tpu_torch
for mod in pkgutil.walk_packages(unit_tpu_torch.__path__, "unit_tpu_torch."):
    importlib.import_module(mod.name)
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.serving import DetectionService

cfg = get_cfg()
cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                     "MODEL.RPN.PRE_NMS_TOPK_TEST", "60", "MODEL.RPN.POST_NMS_TOPK_TEST", "12",
                     "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96"])
model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0)).eval()
with torch.inference_mode():
    dets = model.predict(torch.rand(1, 64, 96, 3) * 255, torch.tensor([[64.0, 90.0]]))
assert dets.boxes.shape[0] == 1 and bool(torch.isfinite(dets.boxes).all())
recs = DetectionService(cfg, model).detect_array(torch.rand(50, 70, 3).numpy() * 255)
assert isinstance(recs, list)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not loaded, loaded
print("no jax")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _RUN_WITHOUT_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("no jax")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_sources_use_no_jax_library_kernels_or_compile():
    banned = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|torchvision)\b"
        r"|(?<![\w.])torch\.(?:compile|ops\.)",
        re.M,
    )
    for path in _sources():
        hits = banned.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)}: {hits}"


def test_only_the_config_package_of_unit_tpu_is_imported():
    imports = re.compile(r"^\s*(?:from|import)\s+(unit_tpu(?:\.[\w.]+)?)\b", re.M)
    for path in _sources():
        for name in imports.findall(path.read_text()):
            assert name == "unit_tpu.config", f"{path.relative_to(REPO)} imports {name}"
