"""utils.events of unit_tpu_torch: the writers of unit_tpu without its console
fault (the first line there shows a false s/it and ETA, from a clock started
at construction and a step count that ignores the resume step).
"""

import json
import logging
import types

import pytest

from unit_tpu.utils import events as jevents
from unit_tpu_torch.utils import events as tevents


@pytest.fixture
def lines():
    out = []

    class Keep(logging.Handler):
        def emit(self, record):
            out.append(record.getMessage())

    lg, handler = logging.getLogger("unit_tpu_torch"), Keep()
    level, propagate = lg.level, lg.propagate
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    yield out
    lg.removeHandler(handler)
    lg.setLevel(level)
    lg.propagate = propagate


def test_storage_matches_unit_tpu():
    t, j = tevents.EventStorage(window_size=3), jevents.EventStorage(window_size=3)
    for i, v in enumerate([5.0, 1.0, 4.0, 2.0, 9.0]):
        for s in (t, j):
            s.put_scalars(loss=v, lr=0.1 * i)
    assert t.latest() == j.latest() and t.median("loss") == j.median("loss") == 4.0
    assert t.median("absent") != t.median("absent")  # nan, as in unit_tpu
    assert j.median("absent") != j.median("absent")


def test_console_prints_no_rate_before_two_samples(lines, monkeypatch):
    # the writer's clock, stepped by the test: the real one also counts the
    # time between the two writes, which a loaded host stretches
    now = [100.0]
    monkeypatch.setattr(tevents, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    w = tevents.ConsoleWriter(max_iter=1000)
    st = tevents.EventStorage()
    st.put_scalars(total_loss=2.5)
    w.write(520, st)  # a resumed run: the first logged step is 520
    assert lines[-1].startswith("iter 520  total_loss 2.5") and "s/it" not in lines[-1]
    assert "eta" not in lines[-1]
    now[0] += 8.0  # 20 steps took 8 s
    w.write(540, st)
    assert "0.4 s/it" in lines[-1] and "eta 3.1m" in lines[-1]  # (1000 - 540) * 0.4 s


def test_metrics_hook_writes_json_lines(tmp_path, lines):
    hook = tevents.MetricsHook(str(tmp_path), period=2, max_iter=6, lr_fn=lambda s: 0.5 * s)
    for step in range(1, 6):
        hook(step, {"total_loss": float(step), "data_time": 0.25}, None)
    hook.close()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.json")]
    assert [r["iteration"] for r in recs] == [2, 4]
    assert recs[1] == {"iteration": 4, "total_loss": 4.0, "data_time": 0.25, "lr": 2.0}
    assert len([line for line in lines if line.startswith("iter ")]) == 2


def test_print_csv_format(lines):
    tevents.print_csv_format({"bbox": {"AP": 1.5, "AP50": 2.25, "class_AP50": {"a": 1.0}},
                              "inference_seconds_per_image": 0.5})
    assert "csv: bbox,AP,1.5000" in lines and "csv: bbox,AP50,2.2500" in lines
    assert "inference_seconds_per_image,0.5" in lines
    assert not any("class_AP50" in line for line in lines)
