"""unit_tpu_torch imports and runs without jax.

The check runs in a subprocess: this test process has already imported jax
(tests/conftest.py).  A source scan adds what an import cannot show: no
library kernel, no torch.compile, and no import of unit_tpu at all (the port
keeps its own copy of what it needs, the config package included).
"""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "unit_tpu_torch"
# the serving CLIs of the port, the benchmark of its operators' host cost,
# the shapes-VOC writer, the step profiler and its analyzer, K4's bench, the
# k-shot split writer and the soak's verifier
SCRIPTS = [REPO / "scripts" / f"{name}_torch.py"
           for name in ("serve", "export_model", "bench_serving", "bench_nograd",
                        "make_shapes_voc", "profile_train_step", "analyze_trace", "bench_k4",
                        "prepare_voc", "verify_soak")]

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
# the serving surface: the registered operators, an artifact, the CLIs
import runpy, tempfile, os
from unit_tpu_torch.ops import library
from unit_tpu_torch.serving import export_predict, load_exported
path = os.path.join(tempfile.mkdtemp(), "model.pt2.pkl")
cfg.merge_from_list(["INPUT.MAX_SIZE_TEST", "64"])
export_predict(cfg, model, path)
assert isinstance(DetectionService(cfg, exported=load_exported(path)).detect_array(
    torch.rand(40, 50, 3).numpy() * 255), list)
for script in SCRIPTS:
    runpy.run_path(script)
# the host loader builds from the port's own source, not unit_tpu's library
from unit_tpu_torch.data import native
if native.available():
    assert "libunit_native" not in native.STATUS["path"], native.STATUS
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "torchvision", "unit_tpu"))
assert not loaded, loaded
print("no jax")
"""


def test_port_imports_and_runs_without_jax():
    code = f"SCRIPTS = {[str(p) for p in SCRIPTS]!r}\n" + _RUN_WITHOUT_JAX
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("no jax")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + SCRIPTS


def test_sources_use_no_jax_library_kernels_or_compile():
    banned = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|torchvision)\b"
        r"|(?<![\w.])torch\.(?:compile|ops\.)",
        re.M,
    )
    for path in _sources():
        hits = banned.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)}: {hits}"


def test_no_source_of_the_port_imports_unit_tpu():
    imports = re.compile(r"^\s*(?:from|import)\s+(unit_tpu(?:\.[\w.]+)?)\b(?!_)", re.M)
    dynamic = re.compile(r"import_module\(\s*[\"']unit_tpu[\"'.]|__import__\(\s*[\"']unit_tpu[\"'.]")
    sources = _sources() + [REPO / "scripts" / "train_VOC_torch.py"]
    assert len(sources) > 50
    for path in sources:
        text = path.read_text()
        names = [n for n in imports.findall(text) if n.split(".")[0] == "unit_tpu"]
        assert not names, f"{path.relative_to(REPO)} imports {names}"
        assert not dynamic.search(text), f"{path.relative_to(REPO)} imports unit_tpu dynamically"


def test_sharding_modules_and_rank_modules_import_no_jax():
    """The FSDP, TP and 2-D mesh modules of the port, and the jax-free test
    modules whose functions the spawned ranks import, load neither jax nor
    unit_tpu."""
    code = ("import sys\n"
            "import unit_tpu_torch.parallel.mesh, unit_tpu_torch.parallel.tensor\n"
            "import unit_tpu_torch.parallel.spatial\n"
            "import tests.test_torch_parallel_run, tests.test_torch_sharded_run\n"
            "import tests.test_torch_spatial_run\n"
            "loaded = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'unit_tpu'))\n"
            "assert not loaded, loaded\n"
            "print('no jax')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("no jax")
    for path in (PORT / "parallel" / "mesh.py", PORT / "parallel" / "tensor.py",
                 PORT / "parallel" / "spatial.py"):
        assert path in _sources()


def test_no_source_of_the_port_loads_unit_tpus_native_library():
    """The port builds its loader from unit_tpu_torch/csrc/dataloader.cc
    (data/native.py); it never loads native/libunit_native.so."""
    for path in _sources():
        assert "libunit_native" not in path.read_text(), path.relative_to(REPO)
