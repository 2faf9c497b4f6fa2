"""The step profiler of unit_tpu_torch (scripts/profile_train_step_torch.py,
scripts/analyze_trace_torch.py, utils/profiling.summarize_trace), on the CPU.

``summarize_trace`` is held to exact sums on a hand-written Chrome trace in
torch.profiler's format: kernels, a copy and a fill on the device, CPU ops
on a forward and a backward thread linked by ``External id`` and
``Sequence number`` / ``Fwd thread id``, and the ``record_function`` ranges
of ``profiling.annotate`` and of the optimizer.  The profiler itself runs
once at a tiny config: the CPU has no device events, so its host rollup is
what can be checked there.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from unit_tpu_torch.models import WSRCNN
from unit_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
FWD, BWD, STREAM = 10, 20, 7
# two intra-op threads in the profiled process, as the test processes hold
ENV = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")


def op(name, ts, dur, ext=None, seq=None, bwd=False, tid=FWD):
    args = {} if ext is None else {"External id": ext}
    if seq is not None:
        args.update({"Sequence number": seq, "Fwd thread id": 1 if bwd else 0})
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def span(name, ts, dur, tid=FWD):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def dev(name, ts, dur, ext=None, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": STREAM, "ts": ts,
            "dur": dur, "args": {} if ext is None else {"External id": ext}}


# microseconds, as torch.profiler writes them
TRACE = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    span("unit:step", 0, 1000),
    op("aten::copy_", 1, 5, ext=6),
    dev("Memcpy HtoD (Pageable -> Device)", 3, 10, ext=6, cat="gpu_memcpy"),
    span("unit:backbone", 10, 90),
    op("aten::conv2d", 20, 30, ext=1, seq=5),
    dev("sm90_xmma_fprop_implicit_gemm_bf16", 30, 40, ext=1),
    span("unit:roi_pooling", 110, 90),
    op("RoIAlignV2Function", 120, 60, ext=2, seq=9),
    dev("void roi_align_fwd_kernel<__nv_bfloat16>", 150, 20, ext=2),
    span("unit:rpn", 210, 70),
    op("nms_keep", 215, 45, ext=8, seq=12),
    dev("nms_survivor_kernel", 230, 15, ext=8),
    dev("void at::native::vectorized_elementwise_kernel<4>", 240, 10, ext=8),
    op("autograd::engine::evaluate_function: RoIAlignV2FunctionBackward", 300, 100, ext=3,
       seq=9, bwd=True, tid=BWD),
    op("aten::zeros", 310, 20, ext=4, tid=BWD),
    dev("void roi_align_bwd_rows<__nv_bfloat16>", 320, 50, ext=4),
    op("autograd::engine::evaluate_function: ConvolutionBackward0", 410, 90, ext=5, seq=5,
       bwd=True, tid=BWD),
    op("aten::convolution_backward", 415, 80, ext=9, tid=BWD),
    dev("sm90_xmma_dgrad_bf16", 420, 30, ext=9),
    span("Optimizer.step#SGD.step", 600, 100),
    op("aten::_foreach_add_", 610, 40, ext=7),
    dev("void at::native::multi_tensor_apply_kernel<foreach_add>", 620, 25, ext=7),
    dev("Memset (Device)", 700, 5, cat="gpu_memset"),
]


@pytest.fixture
def summary(tmp_path):
    path = tmp_path / "host.1.2.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": TRACE}))
    return profiling.summarize_trace(str(path))


def test_totals_and_busy_share(summary):
    assert summary["device_ms"] == pytest.approx(0.205)
    assert summary["device_events"] == 9
    assert summary["window_ms"] == pytest.approx(1.0)
    # the element-wise kernel overlaps K3 by 5 us: the union is 200 us
    assert summary["busy_ms"] == pytest.approx(0.200)
    assert summary["busy_share"] == pytest.approx(0.2)
    assert summary["steps"] == 1
    assert summary["top"][0] == ("void roi_align_bwd_rows<__nv_bfloat16>",
                                 pytest.approx(0.05), 1)


def test_device_time_by_kind(summary):
    want = {"cuDNN conv": 0.070, "K2 roi_align_bwd": 0.050, "elementwise/reduce": 0.035,
            "K1 roi_align_fwd": 0.020, "K3 nms_mask": 0.015, "copies": 0.015}
    assert summary["by_kind"] == pytest.approx(want)
    assert sum(summary["by_kind"].values()) == pytest.approx(summary["device_ms"])


def test_device_time_by_subsystem_forward_and_backward(summary):
    want = {"roi_pooling bwd": 0.050, "backbone fwd": 0.040, "backbone bwd": 0.030,
            "optimizer": 0.025, "rpn fwd": 0.025, "roi_pooling fwd": 0.020, "other": 0.015}
    assert summary["by_subsystem"] == pytest.approx(want)
    assert sum(summary["by_subsystem"].values()) == pytest.approx(summary["device_ms"])


def test_host_time_by_subsystem(summary):
    # the outermost CPU ops only: the backward nodes' children are inside them
    want = {"roi_pooling bwd": 0.100, "backbone bwd": 0.090, "roi_pooling fwd": 0.060,
            "rpn fwd": 0.045, "optimizer": 0.040, "backbone fwd": 0.030, "other": 0.005}
    assert summary["host_by_subsystem"] == pytest.approx(want)


def test_kernel_kinds_name_the_four_kernels():
    assert [profiling.kernel_kind(n) for n in (
        "roi_align_fwd_kernel<float>", "roi_align_bwd_tables", "nms_survivor_kernel",
        "bn_act_fwd_vec<__nv_bfloat16>", "Memcpy DtoH", "something else")] == [
        "K1 roi_align_fwd", "K2 roi_align_bwd", "K3 nms_mask", "K4 bn_act", "copies", "other"]


def test_annotate_leaves_the_model_as_it_was():
    from tests.test_torch_overfit import tiny_config

    model = WSRCNN(tiny_config(), generator=torch.Generator().manual_seed(0))
    before = dict(vars(model))
    with profiling.annotate(model):
        assert "pooled_rois" in vars(model) and model.backbone._forward_pre_hooks
    assert dict(vars(model)).keys() == before.keys()
    assert not model.backbone._forward_pre_hooks and not model.backbone._forward_hooks


def test_profile_tool_and_analyzer_on_the_cpu(tmp_path):
    out = tmp_path / "trace"
    tiny = ["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
            "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "96",
            "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16"]
    run = subprocess.run([sys.executable, str(REPO / "scripts" / "profile_train_step_torch.py"),
                          "--out", str(out), "--device", "cpu", "--steps", "2", *tiny],
                         cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "2 traced train steps" in run.stdout
    js = tmp_path / "summary.json"
    run = subprocess.run([sys.executable, str(REPO / "scripts" / "analyze_trace_torch.py"),
                          str(out), "--json", str(js)],
                         cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "device time by subsystem" in run.stdout
    summary = json.loads(js.read_text())
    assert summary["steps"] == 2 and summary["device_events"] == 0  # no card
    host = summary["host_by_subsystem"]
    for part in ("backbone fwd", "backbone bwd", "rpn fwd", "roi_pooling fwd",
                 "roi_pooling bwd", "box_heads fwd", "box_heads bwd", "predictors fwd",
                 "losses_sampling fwd", "optimizer"):
        assert host.get(part, 0) > 0, (part, host)
    # the annotated parts take most of the host's time
    assert host.get("other", 0) < 0.2 * sum(host.values()), host
