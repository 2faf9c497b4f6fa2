"""torch.export artifacts of unit_tpu_torch (serving/export.py) and the
registered operators they call (ops/library.py).

An artifact is exported and loaded on the CPU and held to the live predict
of the same model: ``valid`` identical, boxes within rtol 1e-6 / atol 1e-5
and scores within rtol 1e-6 / atol 1e-6 (tests/test_serving.py:84-90; the
program runs the same ops on the same weights, so on the CPU it is bit for
bit).  Each operator passes ``torch.library.opcheck`` (schema and fake
tensor) and equals its plain version bit for bit on the CPU.  The tests
marked ``cuda`` hold the operators to the kernels and show that an artifact
launches them; they skip where there is no card.  This file imports no jax,
so those tests also run on the card.
"""

import json
import pickle
import runpy
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine.predict import make_predict_fn
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models.resnet import FrozenBN
from unit_tpu_torch.ops import bn_act as bn_act_ops
from unit_tpu_torch.ops import library
from unit_tpu_torch.ops import nms as nms_ops
from unit_tpu_torch.ops import roi_align as roi_align_ops
from unit_tpu_torch.serving import DetectionService, describe, export_predict, load_exported
from unit_tpu_torch.serving.export import FORMAT_VERSION

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP = REPO / "configs" / "VOC" / "VOC-RCNN-101-C4-split1.yaml"
TINY_OPTS = ["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
             "MODEL.RPN.PRE_NMS_TOPK_TEST", "60", "MODEL.RPN.POST_NMS_TOPK_TEST", "12",
             "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
             "TPU.COMPUTE_DTYPE", "float32", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
             "MODEL.WEIGHTS", ""]
SQUARE = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "64"]  # one 64x64 canvas
BOX_RTOL, BOX_ATOL, SCORE_RTOL, SCORE_ATOL = 1e-6, 1e-5, 1e-6, 1e-6
BATCH_BOX_ATOL, BATCH_BOX_RTOL = 1e-2, 1e-4


def tiny_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_file(str(FLAGSHIP))
    cfg.merge_from_list(TINY_OPTS + list(opts))
    return cfg


def tiny_model(cfg, seed=0):
    """Seeded weights with FrozenBN statistics of a trained-looking network."""
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBN):
                m.weight.copy_(torch.as_tensor(0.5 + rng.rand(*m.weight.shape)))
                m.var.copy_(torch.as_tensor(0.5 + rng.rand(*m.var.shape)))
                m.mean.copy_(torch.as_tensor(rng.randn(*m.mean.shape) * 0.2))
    return model.eval()


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs several such files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(cfg, model, artifact path, metadata) at batch 1, both orientations."""
    cfg = tiny_cfg()
    model = tiny_model(cfg)
    path = str(tmp_path_factory.mktemp("artifact") / "model.pt2.pkl")
    meta = export_predict(cfg, model, path, class_names=[f"c{i}" for i in range(20)])
    return cfg, model, path, meta


def canvas_inputs(seed, key, b=1):
    ch, cw = (int(v) for v in key.split("x"))
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 255, (b, ch, cw, 3)).astype(np.float32)
    sizes = np.asarray([[ch - 4 * i, cw - 6 * i] for i in range(b)], np.float32)
    return images, sizes


def assert_same_program_outputs(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), want.valid.numpy())
    v = want.valid.numpy()
    assert v.any()
    np.testing.assert_array_equal(got.classes.numpy()[v], want.classes.numpy()[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes.numpy()[v], rtol=BOX_RTOL,
                               atol=BOX_ATOL)
    np.testing.assert_allclose(got.scores.numpy()[v], want.scores.numpy()[v],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


def op_counts(program) -> Counter:
    """Calls of the registered operators in a loaded program, nested graphs
    (the no-grad region) included."""
    counts = Counter()
    for mod in program.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for node in mod.graph.nodes:
                name = str(node.target)
                if node.op == "call_function" and name.startswith("unit_tpu_torch."):
                    counts[name.split(".")[1]] += 1
    return counts


def frozen_bn_count(model) -> int:
    return sum(isinstance(m, FrozenBN) for m in model.modules())


def test_export_roundtrip_matches_live_predict(exported):
    cfg, model, path, meta = exported
    assert meta["with_proposals"] is False and meta["batch_size"] == 1
    assert meta["canvases"] == ["64x96", "96x64"] and meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__ and "jax_version" not in meta
    artifact = load_exported(path)
    predict = make_predict_fn(model)
    for seed, key in enumerate(meta["canvases"]):
        images, sizes = canvas_inputs(seed, key)
        assert_same_program_outputs(artifact(images, sizes), predict(images, sizes))


def test_artifact_calls_the_registered_operators(exported):
    """K1 once, K3 for the RPN (one call for the batch) and the final NMS
    (one per image), K4 once per FrozenBN: the calls the card launches."""
    _, model, path, meta = exported
    for program in load_exported(path)._programs.values():
        assert op_counts(program) == {"roi_align": 1, "nms_keep": 2,
                                      "bn_act": frozen_bn_count(model)}


def test_unknown_canvas_and_format_version_raise(exported, tmp_path):
    _, _, path, _ = exported
    artifact = load_exported(path)
    with pytest.raises(ValueError, match="no exported program"):
        artifact(np.zeros((1, 32, 32, 3), np.float32), np.asarray([[32, 32]], np.float32))
    with open(path, "rb") as f:
        payload = pickle.load(f)
    for version in (FORMAT_VERSION + 1, None):
        bad = dict(payload, meta=dict(payload["meta"], format_version=version))
        bad_path = tmp_path / f"v{version}.pkl"
        bad_path.write_bytes(pickle.dumps(bad))
        with pytest.raises(ValueError, match="unsupported artifact version"):
            load_exported(str(bad_path))
    assert json.loads(describe(path)) == payload["meta"]


def test_card_artifact_does_not_load_without_the_card(exported, tmp_path, monkeypatch):
    _, _, path, _ = exported
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["meta"]["platforms"] = ["cuda"]
    card_path = tmp_path / "card.pkl"
    card_path.write_bytes(pickle.dumps(payload))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(str(card_path))


def test_batch2_artifact_serves_through_the_microbatcher(tmp_path):
    """An artifact exported at batch 2 serves through the micro-batcher (a
    group of one is padded to 2) and matches the live batch-1 service
    (tests/test_serving.py:150-171)."""
    cfg = tiny_cfg(*SQUARE)
    model = tiny_model(cfg, seed=1)
    path = str(tmp_path / "b2.pkl")
    meta = export_predict(cfg, model, path, batch_size=2)
    assert meta["batch_size"] == 2 and meta["canvases"] == ["64x64"]
    artifact = load_exported(path)
    svc = DetectionService(cfg, exported=artifact, batch_size=8)
    assert svc.batch_size == 2  # the artifact's
    calls = []
    svc._batcher._predict = lambda i, s: (calls.append(i.shape[0]), artifact(i, s))[1]
    single = DetectionService(cfg, model)
    img = np.random.RandomState(5).uniform(0, 255, (50, 60, 3)).astype(np.float32)
    got, want = svc.detect_array(img), single.detect_array(img)
    svc.close()
    assert calls == [2] and len(got) == len(want) > 0
    for dg, dw in zip(got, want):
        assert dg["class_id"] == dw["class_id"]
        np.testing.assert_allclose(dg["box"], dw["box"], rtol=BATCH_BOX_RTOL,
                                   atol=BATCH_BOX_ATOL)


@pytest.mark.parametrize("variant", ["proposals", "weak_only", "fold_bn"])
def test_artifact_variants_match_live_predict(variant, tmp_path):
    """Precomputed proposals (two more inputs; the RPN does not run, so K3
    runs for the final NMS alone), WeakRCNN's predict_weak_only, and
    TPU.FOLD_BN_AT_EVAL (the program holds the folded weights)."""
    opts = {"proposals": ["MODEL.LOAD_PROPOSALS", "True",
                          "DATASETS.PROPOSAL_FILES_TEST", "('proposals.pkl',)",
                          "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "16"],
            "weak_only": ["MODEL.META_ARCHITECTURE", "WeakRCNN"],
            "fold_bn": ["TPU.FOLD_BN_AT_EVAL", "True"]}[variant]
    cfg = tiny_cfg(*SQUARE, *opts)
    model = tiny_model(cfg, seed=2)
    path = str(tmp_path / "v.pkl")
    meta = export_predict(cfg, model, path, batch_size=2)
    assert meta["with_proposals"] == (variant == "proposals")
    artifact = load_exported(path)
    images, sizes = canvas_inputs(3, "64x64", b=2)
    extra = ()
    if variant == "proposals":
        assert meta["proposal_capacity"] == 16
        rng = np.random.RandomState(4)
        xy = rng.uniform(0, 40, (2, 16, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 24, (2, 16, 2))], -1).astype(np.float32)
        valid = np.arange(16)[None] < np.asarray([[16], [9]])
        extra = (boxes, valid)
    live = model
    if variant == "fold_bn":
        from unit_tpu_torch.utils.bn_fold import fold_frozen_bn

        live = fold_frozen_bn(model)
    assert_same_program_outputs(artifact(images, sizes, *extra),
                                make_predict_fn(live)(images, sizes, *extra))
    counts = op_counts(artifact._programs["64x64"])
    assert counts["nms_keep"] == (2 if variant == "proposals" else 3)
    assert counts["roi_align"] == 1
    # a folded FrozenBN keeps its shift; predict_weak_only runs the weak Res5 head alone
    unused = frozen_bn_count(model.box_head) if variant == "weak_only" else 0
    assert counts["bn_act"] == frozen_bn_count(model) - unused
    if variant == "proposals":
        with pytest.raises(ValueError, match="with_proposals"):
            DetectionService(cfg, exported=artifact)


def test_export_cli(tmp_path, capsys):
    cli = runpy.run_path(str(REPO / "scripts" / "export_model_torch.py"))
    out = str(tmp_path / "cli.pkl")
    args = ["--config-file", str(FLAGSHIP), "--out", out, "--batch-size", "2",
            *TINY_OPTS, *SQUARE, "OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli["main"](args)
    cli["main"](["--device", "cpu", *args])
    assert f"-> {out}" in capsys.readouterr().out
    cli["main"](["--describe", out])
    meta = json.loads(capsys.readouterr().out)
    assert (meta["batch_size"], meta["canvases"], meta["platforms"]) == (2, ["64x64"], ["cpu"])
    assert meta["class_names"][:2] == ["aeroplane", "bicycle"]


# -------------------------------------------------------------- the operators
def roi_inputs(dtype, c=8):
    rng = np.random.RandomState(0)
    feats = torch.as_tensor(rng.randn(2, 10, 12, c).astype(np.float32)).to(dtype)
    xy = rng.uniform(-20, 150, (2, 7, 2))
    rois = torch.as_tensor(np.concatenate([xy, xy + rng.uniform(1, 90, (2, 7, 2))], -1),
                           dtype=torch.float32)
    return feats, rois


def nms_inputs():
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 60, (3, 40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (3, 40, 2))], -1).astype(np.float32)
    n_valid = np.asarray([40, 25, 0], np.int32)
    boxes[np.arange(40)[None] >= n_valid[:, None]] = 0.0
    return torch.as_tensor(boxes), torch.as_tensor(n_valid)


def bn_inputs(dtype, residual, channels_last):
    rng = np.random.RandomState(2)
    x = torch.as_tensor(rng.randn(2, 6, 5, 7).astype(np.float32)).to(dtype)
    res = torch.as_tensor(rng.randn(2, 6, 5, 7).astype(np.float32)).to(dtype)
    if channels_last:
        x, res = (t.contiguous(memory_format=torch.channels_last) for t in (x, res))
    scale = torch.as_tensor(rng.rand(6).astype(np.float32) + 0.5)
    shift = torch.as_tensor(rng.randn(6).astype(np.float32))
    return x, scale, shift, res if residual else None


OPCHECK = ("test_schema", "test_faketensor")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_operator(dtype):
    feats, rois = roi_inputs(dtype)
    args = (feats, rois, 5, 1.0 / 16.0, 2)
    torch.library.opcheck(library.roi_align, args, test_utils=OPCHECK)
    got = library.roi_align(*args)
    assert got.dtype == dtype
    assert torch.equal(got, roi_align_ops.roi_align_plain(*args))


@pytest.mark.parametrize("max_keep", [40, 6, 0])
def test_nms_keep_operator(max_keep):
    boxes, n_valid = nms_inputs()
    args = (boxes, n_valid, 0.5, max_keep)
    torch.library.opcheck(library.nms_keep, args, test_utils=OPCHECK)
    keep = library.nms_keep(*args)
    assert keep.dtype == torch.bool and keep.shape == (3, 40)
    assert torch.equal(keep, nms_ops.nms_sorted_mask_plain(boxes, 0.5, max_keep))
    assert not keep[2].any()
    # without the hint (None: no count is made up on the device), the same mask
    torch.library.opcheck(library.nms_keep, (boxes, None, 0.5, max_keep), test_utils=OPCHECK)
    assert torch.equal(library.nms_keep(boxes, None, 0.5, max_keep), keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("channels_last", [False, True])
def test_bn_act_operator(dtype, residual, channels_last):
    x, scale, shift, res = bn_inputs(dtype, residual, channels_last)
    for relu in (True, False):
        args = (x, scale, shift, res, relu)
        torch.library.opcheck(library.bn_act, args, test_utils=OPCHECK)
        got = library.bn_act(*args)
        assert got.stride() == torch.empty_like(x).stride()
        assert torch.equal(got, bn_act_ops.bn_act_plain(*args))


def test_dispatchers_call_the_operators_without_a_gradient(monkeypatch):
    """"auto" goes through the operators where no gradient is taken; a
    gradient keeps the autograd paths, and "plain" the plain versions."""
    calls = []
    for name in ("roi_align", "nms_keep", "bn_act"):
        real = getattr(library, name)
        monkeypatch.setattr(library, name,
                            lambda *a, _n=name, _r=real: (calls.append(_n), _r(*a))[1])
    feats, rois = roi_inputs(torch.float32)
    boxes, n_valid = nms_inputs()
    x, scale, shift, res = bn_inputs(torch.float32, True, True)
    with torch.no_grad():
        roi_align_ops.roi_align_batched(feats, rois, 5)
        nms_ops.nms_sorted_mask(boxes, 0.5, 10, n_valid=n_valid)
        nms_ops.nms_sorted_mask(boxes[0], 0.5)  # one image, no hint
        bn_act_ops.bn_act(x, scale, shift, res)
    assert calls == ["roi_align", "nms_keep", "nms_keep", "bn_act"]
    calls.clear()
    roi_align_ops.roi_align_batched(feats.requires_grad_(), rois, 5).sum().backward()
    bn_act_ops.bn_act(x.requires_grad_(), scale, shift, res).sum().backward()
    with torch.no_grad():
        roi_align_ops.roi_align_batched(feats, rois, 5, impl="plain")
        nms_ops.nms_sorted_mask(boxes, 0.5, 10, impl="plain")
        bn_act_ops.bn_act(x, scale, shift, res, impl="plain")
    assert calls == []
    with pytest.raises(ValueError, match="CUDA"):
        nms_ops.nms_sorted_mask(boxes, 0.5, 10, impl="cuda")


# ------------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_operators_launch_the_kernels(cuda_device):
    from unit_tpu_torch.ops import bn_act_cuda, nms_cuda, roi_align_cuda

    feats, rois = roi_inputs(torch.float32, c=64)
    boxes, n_valid = nms_inputs()
    x, scale, shift, res = bn_inputs(torch.bfloat16, True, True)
    counters = (roi_align_cuda.roi_align_cuda, nms_cuda.nms_sorted_mask_cuda,
                bn_act_cuda.bn_act_forward_cuda)
    before = [f.launches for f in counters]
    got = (library.roi_align(feats.to(cuda_device), rois.to(cuda_device), 5, 1 / 16, 2),
           library.nms_keep(boxes.to(cuda_device), n_valid.to(cuda_device), 0.5, 40),
           library.bn_act(*(t.to(cuda_device) for t in (x, scale, shift, res)), True))
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [b + 1 for b in before]
    # K1 sums in another order than its plain version: chip_smoke.py's f32 bound
    torch.testing.assert_close(got[0].cpu(), roi_align_ops.roi_align_plain(
        feats, rois, 5, 1 / 16, 2), atol=2e-5, rtol=0)
    assert torch.equal(got[1].cpu(), nms_ops.nms_sorted_mask_plain(boxes, 0.5, 40))
    assert torch.equal(got[2].cpu(), bn_act_ops.bn_act_plain(x, scale, shift, res, True))
    assert got[2].stride() == x.stride()
    # without the hint the wrapper is given no count: the kernel walks every row
    assert torch.equal(library.nms_keep(boxes.to(cuda_device), None, 0.5, 40).cpu(), got[1].cpu())


@pytest.mark.cuda
def test_card_artifact_launches_the_kernels(cuda_device, tmp_path):
    from unit_tpu_torch.ops import bn_act_cuda, nms_cuda, roi_align_cuda

    cfg = tiny_cfg(*SQUARE)
    model = tiny_model(cfg).to(cuda_device)
    path = str(tmp_path / "card.pkl")
    assert export_predict(cfg, model, path)["platforms"] == ["cuda"]
    artifact = load_exported(path)
    counters = (roi_align_cuda.roi_align_cuda, nms_cuda.nms_sorted_mask_cuda,
                bn_act_cuda.bn_act_forward_cuda)
    before = [f.launches for f in counters]
    images, sizes = canvas_inputs(0, "64x64")
    got = artifact(images, sizes)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 2, frozen_bn_count(model)]
    want = make_predict_fn(model)(images, sizes)
    assert torch.equal(got.valid, want.valid) and torch.equal(got.boxes, want.boxes)


def test_detections_type_is_the_services():
    """ExportedPredictor returns the Detections the service packs."""
    from unit_tpu_torch.serving.export import ExportedPredictor
    from unit_tpu_torch.structures.instances import Detections

    out = {"boxes": torch.zeros(1, 2, 4), "scores": torch.zeros(1, 2),
           "classes": torch.zeros(1, 2, dtype=torch.int64),
           "valid": torch.zeros(1, 2, dtype=torch.bool)}
    pred = ExportedPredictor({"platforms": ["cpu"]}, {"8x8": lambda *a: out})
    det = pred(np.zeros((1, 8, 8, 3), np.float32), np.ones((1, 2), np.float32))
    assert isinstance(det, Detections) and det.masks is None
