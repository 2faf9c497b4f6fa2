"""The deferred loss fetch of unit_tpu_torch's trainer (``engine.train.LazyMetrics``).

``run_step`` returns a step's losses in flight; the trainer resolves them
``metrics_pipeline_depth`` (8) steps later, oldest first, before any plain
hook and at the end of ``train()``.  Here:

  * the port's ``MetricsHook`` writes the ``metrics.json`` lines that
    unit_tpu's writes when both get the same values as their own lazy
    mappings (unit_tpu's over jnp scalars), and resolves them only at its
    write boundary;
  * a trainer at depth 8 takes the steps of one at depth 0: the same losses
    in ``metrics_history`` and the same parameters, bit for bit; a hook
    that takes lazy metrics gets steps 1-8 unresolved at depth 8 and every
    step resolved at depth 0;
  * a non-finite loss at step k raises when it is drained, naming step k,
    and no checkpoint of step k or later is written (unit_tpu's order, R3,
    runs the checkpoint hook on step k first);
  * the mapping: ``==`` against a dict, ``dict()``, ``**``, ``pop`` and
    pickling as the dict of its values.
"""

import itertools
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from tests.test_torch_parallel_run import params_digest
from tests.test_torch_train import tiny_trainer
from unit_tpu.engine.train import LazyMetrics as JLazyMetrics
from unit_tpu.utils import events as jevents
from unit_tpu_torch.checkpoint import Checkpointer, PeriodicCheckpointerWithEval
from unit_tpu_torch.engine.train import LazyMetrics
from unit_tpu_torch.utils import events as tevents

STEPS = 10  # past the depth: steps 9 and 10 resolve the oldest in run_step


class OneByOne:
    """The trainer's part of a resolution, for mappings made without one."""

    def _resolve_through(self, metrics):
        metrics._settle(lambda values: values.tolist())


def lazy_pair(step, values, data_time=0.25):
    """unit_tpu's and the port's lazy mappings of the same f32 values."""
    j = JLazyMetrics({k: jnp.float32(v) for k, v in values.items()}, data_time, step, True)
    t = LazyMetrics(OneByOne(), step, list(values),
                    torch.tensor(list(values.values()), dtype=torch.float32), None, data_time)
    return j, t


def test_metrics_hook_writes_what_unit_tpus_writes(tmp_path):
    jhook = jevents.MetricsHook(str(tmp_path / "j"), period=3, max_iter=7,
                                lr_fn=lambda s: 0.01 * s)
    thook = tevents.MetricsHook(str(tmp_path / "t"), period=3, max_iter=7,
                                lr_fn=lambda s: 0.01 * s)
    seen = []
    for step in range(1, 8):
        values = {"total_loss": 2.5 + 0.1 * step, "loss_cls": 0.3 / step}
        j, t = lazy_pair(step, values)
        jhook(step, j, None)
        thook(step, t, None)
        seen.append((step, t))
        # kept in flight until the write boundary, then resolved at once
        assert all(m.resolved == (s <= step // 3 * 3) for s, m in seen)
    thook.close()
    lines = [[json.loads(line) for line in open(tmp_path / d / "metrics.json")]
             for d in ("j", "t")]
    assert [r["iteration"] for r in lines[1]] == [3, 6] and lines[0] == lines[1]


def test_lazy_metrics_is_a_mapping_of_its_floats():
    _, t = lazy_pair(4, {"total_loss": 1.5, "loss_box_reg": 0.25})
    want = {"total_loss": 1.5, "loss_box_reg": 0.25, "data_time": 0.25}
    assert not t.resolved and "in flight" in repr(t)
    assert t == want and dict(t) == want and dict(**t) == want
    assert json.loads(json.dumps(dict(t))) == want
    again = pickle.loads(pickle.dumps(t))
    assert type(again) is dict and again == want
    assert t.pop("data_time") == 0.25 and t == {"total_loss": 1.5, "loss_box_reg": 0.25}


class Resolved:
    """A hook that takes lazy metrics and records whether each came resolved."""

    takes_lazy_metrics = True

    def __init__(self):
        self.seen = []

    def __call__(self, step, metrics, trainer):
        self.seen.append((step, metrics.resolved))


def run_at_depth(depth):
    trainer, _, _ = tiny_trainer()
    trainer.metrics_pipeline_depth = depth
    hook = Resolved()
    trainer.train(STEPS, hooks=[hook])
    losses = [{k: v for k, v in m.items() if k != "data_time"} for m in trainer.metrics_history]
    return losses, params_digest(trainer.model), hook.seen, trainer


def test_depth_eight_takes_the_steps_of_depth_zero():
    deferred, digest8, seen8, trainer = run_at_depth(8)
    eager, digest0, seen0, _ = run_at_depth(0)
    assert deferred == eager and digest8 == digest0 and len(eager) == STEPS
    assert all(np.isfinite(v) for m in eager for v in m.values())
    assert seen0 == [(s, True) for s in range(1, STEPS + 1)]
    # at depth 8 step k is in flight at its hook: it resolves when step k + 8 runs
    assert seen8 == [(s, False) for s in range(1, STEPS + 1)]
    assert all(m.resolved for m in trainer.metrics_history) and not trainer._inflight


def nan_from(trainer, step):
    """Make the trainer's strong stream non-finite from ``step`` on."""
    s = next(trainer.strong_iter)
    bad = dict(s, image=np.full_like(s["image"], np.nan))
    trainer.strong_iter = itertools.chain([s] * (step - 1), itertools.repeat(bad))


def test_a_non_finite_step_raises_when_drained_naming_its_step(tmp_path):
    trainer, _, _ = tiny_trainer()
    nan_from(trainer, 3)
    metrics = tevents.MetricsHook(str(tmp_path), period=20)
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 3") as err:
        trainer.train(6, hooks=[metrics])  # no hook drains: train()'s own drain raises
    assert "loss_rpn_cls" in str(err.value) and trainer.state.step == 6
    assert not trainer._inflight


def test_no_checkpoint_follows_a_non_finite_step(tmp_path):
    trainer, _, _ = tiny_trainer()
    nan_from(trainer, 3)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=10)
    hooks = [tevents.MetricsHook(str(tmp_path), period=20),
             PeriodicCheckpointerWithEval(ckpt, None, 0, checkpoint_period=1)]
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 3"):
        trainer.train(6, hooks=hooks)
    # the saver drained steps 1-3 before saving step 3: unit_tpu's hook
    # order would have written step 3 (and later ones) before its check
    assert trainer.state.step == 3 and ckpt.all_steps() == [1, 2]
