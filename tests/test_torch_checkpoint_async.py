"""Background checkpoint writes of unit_tpu_torch (``checkpoint.Checkpointer``).

The port's counterpart of tests/test_checkpoint.py::test_async_save_lands_after_wait:
``save`` snapshots the state to host memory and returns while a writer
thread writes the file; ``wait()``, ``restore``, ``latest_step`` and
``all_steps`` (and every read of the module) join it.  The writer is held
back by a gate here, so each test sees the write in flight:

  * ``save`` returns before the file exists; state changed in place after
    it does not reach the file (the restore equals the state at call time);
  * ``latest_step``, ``restore`` (also through another ``Checkpointer``) and
    ``all_steps`` join the write; ``max_to_keep`` prunes after it;
  * a second ``save`` joins the first (the writes never overlap), and the
    best snapshot goes through the same writer;
  * a writer's exception is raised at ``wait()`` (and not again after);
  * ``save(..., wait=True)`` returns with the file in place.
"""

import os
import threading

import pytest
import torch

from tests.test_torch_train import tiny_trainer
from unit_tpu_torch.checkpoint import Checkpointer, checkpointer, read_checkpoint


@pytest.fixture
def gate(monkeypatch):
    """The writer waits for ``gate.set()`` before each file; ``gate.log``
    records each write's start and end."""
    real, opened = checkpointer._write, threading.Event()
    opened.log = []

    def held(path, payload):
        opened.log.append(("start", os.path.basename(path)))
        assert opened.wait(10)
        real(path, payload)
        opened.log.append(("end", os.path.basename(path)))

    monkeypatch.setattr(checkpointer, "_write", held)
    yield opened
    opened.set()
    checkpointer.wait_for_writes()


def state_copy(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_async_save_lands_after_wait(tmp_path, gate):
    trainer, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    want, trainer.state.step = state_copy(trainer), 1
    path = ckpt.save(1, trainer.state)
    assert not os.path.exists(path)  # the write is in flight
    with torch.no_grad():  # the next step's in-place changes
        for p in trainer.model.parameters():
            p.add_(100.0)
    trainer.state.step = 7
    gate.set()
    assert ckpt.latest_step() == 1  # joins the write
    payload = ckpt.restore(1)
    assert payload["step"] == 1
    assert all(torch.equal(payload["model"][k], want[k]) for k in want)
    ckpt.wait()


def test_reads_join_the_write_and_max_to_keep_prunes_after_it(tmp_path, gate):
    trainer, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        trainer.state.step = step
        if step == 2:  # the write of step 1 lands a moment later
            threading.Timer(0.2, gate.set).start()
        ckpt.save(step, trainer.state)
        if step == 2:  # the second save joined the first
            assert os.path.exists(tmp_path / "step_1.pt")
    assert ckpt.all_steps() == [2, 3]
    assert gate.log == [(e, f"step_{s}.pt") for s in (1, 2, 3) for e in ("start", "end")]
    other, _, _ = tiny_trainer()
    Checkpointer(str(tmp_path)).restore(state=other.state)  # another object joins it too
    assert other.state.step == 3


def test_best_snapshot_goes_through_the_same_writer(tmp_path, gate):
    trainer, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, trainer.state)
    threading.Timer(0.2, gate.set).start()
    assert ckpt.maybe_save_best(2, 10.0, trainer.state)  # after the save's write
    assert ckpt._load_best_info() == {"AP50": 10.0, "iteration": 2}  # written at once
    assert ckpt.maybe_save_best(4, 20.0, trainer.state)  # after the first best's write
    assert read_checkpoint(str(tmp_path / "best"))["best_info"] == {"AP50": 20.0, "iteration": 4}
    assert [e for e in gate.log if e[0] == "start"] == [
        ("start", "step_2.pt"), ("start", "model.pt"), ("start", "model.pt")]


def test_a_failed_write_raises_at_wait(tmp_path, monkeypatch):
    def broken(path, payload):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpointer, "_write", broken)
    trainer, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, trainer.state)  # returns: the failure is the writer's
    with pytest.raises(RuntimeError, match="background checkpoint write failed") as err:
        ckpt.wait()
    assert isinstance(err.value.__cause__, OSError)
    ckpt.wait()  # raised once
    monkeypatch.undo()
    assert os.path.exists(ckpt.save(2, trainer.state, wait=True))
    assert ckpt.all_steps() == [2]
