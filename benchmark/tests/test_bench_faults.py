"""A run with the timed path broken underneath comes out not correct: the
harness of each cell is driven on the CPU at a tiny size (the look for a
card skipped) with one fault the cell can have planted in the program.
A step that leaves the state unchanged; half of each batch left out, the
mean taken over the rest; every learning rate 1.3 times the recipe's; a
box of the loader's batch moved by a pixel.  (One card: no exchange between
chips to leave out.)"""

import time

import pytest

import bench_testlib as lib


def result_of(name, seed=5):
    import run

    cell = lib.tiny_cell(name)
    from harness import train

    out = train.run(cell, seed, 1.0, False, time.perf_counter(), device="cpu")
    return run.make_result(cell, out, False)


def no_update(monkeypatch):
    from unit_tpu_torch.engine import train

    def apply_update(trainable, reduce, clip, optimizer, scheduler):
        scheduler.step()  # the step "runs", the state stays as it was

    monkeypatch.setattr(train, "_apply_update", apply_update)


def half_batch(monkeypatch):
    from unit_tpu_torch.models.meta_arch import WSRCNN

    orig = WSRCNN.train_losses

    def train_losses(self, generator, strong, weak, *a, **kw):
        def half(batch):
            if batch is None:
                return None
            n = batch["image"].shape[0] // 2
            return {k: v[:n] for k, v in batch.items()}

        return orig(self, generator, half(strong), half(weak), *a, **kw)

    monkeypatch.setattr(WSRCNN, "train_losses", train_losses)


def lr_too_high(monkeypatch):
    from unit_tpu_torch.engine import train

    orig = train._apply_update

    def apply_update(trainable, reduce, clip, optimizer, scheduler):
        for g in optimizer.param_groups:
            g["lr"] *= 1.3
        orig(trainable, reduce, clip, optimizer, scheduler)

    monkeypatch.setattr(train, "_apply_update", apply_update)


def moved_box(monkeypatch):
    from unit_tpu_torch.data import loader

    orig = loader.StreamLoader._emit

    def _emit(self, batch):
        out = orig(self, batch)
        if "gt_boxes" in out:
            out["gt_boxes"] = out["gt_boxes"] + 1.0
        return out

    monkeypatch.setattr(loader.StreamLoader, "_emit", _emit)


@pytest.mark.parametrize("name,fault", [
    ("voc-r101-c4.train", no_update), ("voc-r101-c4.train", half_batch),
    ("voc-r101-c4.train", lr_too_high), ("voc-r101-c4.train", moved_box),
    ("coco-r50-c4-segm.train", no_update), ("coco-r50-c4-segm.train", half_batch)])
def test_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    fault(monkeypatch)
    result = result_of(name)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", ["voc-r101-c4.train", "coco-r50-c4-segm.train"])
def test_control_is_not_correct(name, monkeypatch, tmp_path):
    """The control (the reference with float8-rounded convolutions and batch
    norms) in the program's place fails one of the cell's limits."""
    import torch

    from harness import common, train, traffic

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = lib.tiny_cell(name)
    dev = torch.device("cpu")
    s = train.set_up(cell, 5, dev, traffic.scratch_dir("control"))
    s["trainer"].close()
    batches, gaps = train.reference_batches(cell, s, dev)
    ref = train.check(cell, s, dev, batches)
    control = train.check(cell, s, dev, batches, fp8=True)
    numbers = dict(train.compare(control, ref, float(cell.mix["round_off"])), **gaps)
    checks = {k: {"value": numbers[k], "limit": float(v)} for k, v in cell.limits.items()}
    assert common.judge(checks) is False, checks
