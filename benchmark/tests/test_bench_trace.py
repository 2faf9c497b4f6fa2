"""The trace reading on a small recorded trace written by hand: device
events charged to the ranges around their ops (every one, not only the
innermost), backward kernels to the forward op's ranges by the sequence
number, the busy union, and the idle gaps named by the launching thread."""

import json

import bench_testlib  # noqa: F401  (import paths)
from harness.trace import merged, summarize


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_summarize_small_trace(tmp_path):
    events = [
        ev("unit:step", "user_annotation", 0, 1000),
        ev("unit:backbone", "user_annotation", 10, 400),
        ev("unit:k4", "user_annotation", 100, 100),
        ev("aten::conv", "cpu_op", 20, 50, **{"External id": 1, "Sequence number": 7}),
        ev("_BnActCuda", "cpu_op", 110, 50, **{"External id": 2, "Sequence number": 8}),
        # the backward of the K4 op, on the autograd thread
        ev("_BnActCudaBackward", "cpu_op", 600, 50, tid=2,
           **{"External id": 3, "Sequence number": 8, "Fwd thread id": 1}),
        ev("aten::sub", "cpu_op", 700, 200, **{"External id": 4}),
        ev("conv_kernel", "kernel", 30, 100, tid=9, **{"External id": 1}),
        ev("bn_act_fwd", "kernel", 150, 50, tid=9, **{"External id": 2}),
        ev("bn_act_bwd", "kernel", 620, 80, tid=9, **{"External id": 3}),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(path))
    assert s["steps"] == 1
    assert s["window_s"] == 1000e-6
    assert abs(s["busy_s"] - 230e-6) < 1e-12
    r = s["ranges"]
    assert abs(r["backbone fwd"] - 150e-6) < 1e-12       # the conv and the K4 forward
    assert abs(r["k4 fwd"] - 50e-6) < 1e-12
    assert abs(r["k4 bwd"] - 80e-6) < 1e-12               # by the sequence number
    assert abs(r["backbone bwd"] - 80e-6) < 1e-12
    assert s["device_ops"][0][0] == "conv_kernel"
    gaps = dict(s["idle_gaps"])
    # 0-30 in the step's conv op's range, 200-620 and 700-1000 on thread 1
    assert abs(sum(gaps.values()) - (1000 - 230) * 1e-6) < 1e-12
    assert "aten::sub" in gaps


def test_merged_intervals():
    assert merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
