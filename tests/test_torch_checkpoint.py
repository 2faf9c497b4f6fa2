"""Checkpoints of unit_tpu_torch: the save/restore round trip, retention, the
best-AP bookkeeping, and the ingestion of d2/MSRA ResNet weights held against
unit_tpu's loader and the committed MSRA golden activations.

A restored state equals the saved one bit for bit (model tensors, momentum
buffers, scheduler counters, step), and a step taken from it equals the step
the saved trainer takes next.  ``load_torch_resnet`` matches
``unit_tpu.checkpoint.load_torch_resnet`` leaf by leaf, exactly (a copy and a
transpose), and reproduces tests/fixtures/msra_mini_C4_golden.npz to the
bound of tests/test_msra_golden.py (rtol = atol = 2e-4).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_train import tiny_trainer
from unit_tpu.checkpoint import load_torch_resnet as jload_torch_resnet
from unit_tpu.models.resnet import Res5 as JRes5
from unit_tpu.models.resnet import ResNetC4 as JResNetC4
from unit_tpu_torch.checkpoint import (
    Checkpointer,
    PeriodicCheckpointerWithEval,
    d2_resnet_key_to_torch,
    load_torch_resnet,
    merge_params_from_checkpoint,
    read_checkpoint,
)
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_path, to_flax_layout
from unit_tpu_torch.models.resnet import Res5, ResNetC4

HERE = os.path.dirname(__file__)
PTH = os.path.join(HERE, "fixtures", "msra_mini_C4.pth")
GOLDEN = os.path.join(HERE, "fixtures", "msra_mini_C4_golden.npz")


def momentum(trainer):
    opt = trainer.optimizer.optimizer
    return [opt.state[p]["momentum_buffer"] for g in opt.param_groups for p in g["params"]]


def test_round_trip_is_bit_identical_and_training_continues_the_same(tmp_path):
    a, _, _ = tiny_trainer()
    a.train(2)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    path = ckpt.save(2, a.state)
    assert os.path.basename(path) == "step_2.pt" and ckpt.latest_step() == 2
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]

    b, _, _ = tiny_trainer()
    assert not torch.equal(b.model.rpn_head.conv.weight, a.model.rpn_head.conv.weight)
    assert Checkpointer(str(tmp_path)).restore(state=b.state) is b.state
    assert b.state.step == 2
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    ma, mb = momentum(a), momentum(b)
    assert len(ma) == len(mb) > 10 and all(torch.equal(x, y) for x, y in zip(ma, mb))
    assert b.optimizer.scheduler.state_dict() == a.optimizer.scheduler.state_dict()
    assert b.optimizer.scheduler.last_epoch == 2
    assert [g["lr"] for g in b.optimizer.optimizer.param_groups] == \
        [g["lr"] for g in a.optimizer.optimizer.param_groups]
    m_a, m_b = a.run_step(), b.run_step()
    m_a.pop("data_time"), m_b.pop("data_time")
    assert m_a == m_b
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_payload_is_plain_and_foreign_files_are_refused(tmp_path):
    t, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(0, t.state)
    payload = ckpt.restore()
    assert payload["format"] == "unit_tpu_torch/1" and payload["step"] == 0
    assert set(payload) == {"format", "step", "model", "optimizer", "scheduler", "best_info"}
    assert all(v.device.type == "cpu" for v in payload["model"].values())
    other = tmp_path / "foreign.pt"
    torch.save({"model": {}}, other)
    with pytest.raises(ValueError, match="not a unit_tpu_torch/1 checkpoint"):
        read_checkpoint(str(other))
    assert Checkpointer(str(tmp_path / "empty")).restore() is None


def test_max_to_keep(tmp_path):
    t, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (3, 6, 9, 12):
        t.state.step = step
        ckpt.save(step, t.state)
    assert ckpt.all_steps() == [9, 12] and ckpt.latest_step() == 12
    assert ckpt.restore(step=9)["step"] == 9
    ckpt.wait()


def test_best_ap_tracking_survives_a_restart(tmp_path):
    t, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.maybe_save_best(10, 50.0, t.state)
    assert not ckpt.maybe_save_best(20, 40.0, t.state)  # worse: not saved
    assert ckpt.best_info == {"AP50": 50.0, "iteration": 10}
    with open(tmp_path / "best_info.json") as f:
        assert json.load(f) == {"AP50": 50.0, "iteration": 10}
    assert read_checkpoint(str(tmp_path / "best"))["best_info"]["AP50"] == 50.0
    # a new process: the best so far is warm-started from disk
    again = Checkpointer(str(tmp_path), max_to_keep=2)
    assert again.best_info["AP50"] == 50.0
    assert not again.maybe_save_best(30, 45.0, t.state)
    assert again.maybe_save_best(40, 60.0, t.state)
    assert read_checkpoint(str(tmp_path / "best"))["best_info"] == {"AP50": 60.0, "iteration": 40}


def test_periodic_hook_saves_evaluates_and_tracks_best(tmp_path):
    t, _, _ = tiny_trainer()
    ckpt = Checkpointer(str(tmp_path))
    aps = iter([{"bbox": {"AP50": 10.0}}, {"voc": {"bbox": {"AP50": 30.0}}}, {"bbox": {"AP50": 5.0}}])
    calls = []

    def eval_fn(state):
        calls.append(state.step)
        return next(aps)

    hook = PeriodicCheckpointerWithEval(ckpt, eval_fn, eval_period=2, checkpoint_period=3,
                                        min_eval_period=2)
    for step in range(1, 7):
        t.state.step = step
        hook(step, {}, t)
    assert ckpt.all_steps() == [3, 6] and calls == [2, 4, 6]
    assert ckpt.best_info == {"AP50": 30.0, "iteration": 4}
    assert hook.last_eval_results == {"bbox": {"AP50": 5.0}}


def test_key_mapping():
    assert d2_resnet_key_to_torch("stem.conv1.weight") == "backbone.stem_conv1.weight"
    assert d2_resnet_key_to_torch("backbone.stem.conv1.norm.running_mean") == \
        "backbone.stem_conv1_bn.mean"
    assert d2_resnet_key_to_torch("res2.0.conv3.norm.weight") == \
        "backbone.res2.block0.conv3_bn.weight"
    assert d2_resnet_key_to_torch("backbone.bottom_up.res4.22.shortcut.weight") == \
        "backbone.res4.block22.shortcut.weight"
    assert d2_resnet_key_to_torch("res5.2.conv1.weight") == "box_head.res5.block2.conv1.weight"
    assert d2_resnet_key_to_torch("roi_heads.res5.0.shortcut.norm.running_var") == \
        "box_head.res5.block0.shortcut_bn.var"
    assert d2_resnet_key_to_torch("fc1000_w") is None


class Heads(nn.Module):
    """backbone + the two Res5 heads, under the names WSRCNN gives them."""

    def __init__(self, depth=26, res2=32):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.backbone = ResNetC4(depth=depth, res2_out_channels=res2, generator=g)
        self.box_head = Res5(depth=depth, res2_out_channels=res2, generator=g)
        self.weak_box_head = Res5(depth=depth, res2_out_channels=res2, generator=g)


@pytest.fixture(scope="module")
def msra_state_dict(tmp_path_factory):
    sys.path.insert(0, os.path.join(HERE, "..", "scripts"))
    from convert_torch_weights import convert

    out = tmp_path_factory.mktemp("msra") / "msra_mini_C4.npz"
    return dict(np.load(convert(PTH, str(out))))


def test_load_torch_resnet_reproduces_the_msra_golden(msra_state_dict):
    golden = np.load(GOLDEN)
    model = Heads().eval()
    _, loaded, skipped = load_torch_resnet(model, msra_state_dict,
                                           load_res5_into=("box_head", "weak_box_head"))
    assert loaded > 100 and "fc1000_w" in skipped
    assert torch.equal(model.box_head.res5.block0.conv1.weight,
                       model.weak_box_head.res5.block0.conv1.weight)
    with torch.no_grad():
        res4 = model.backbone(torch.as_tensor(golden["x"])).permute(0, 2, 3, 1).numpy()
        res5 = model.box_head(torch.as_tensor(golden["pooled"])).numpy()
    np.testing.assert_allclose(res4, golden["res4"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res5, golden["res5"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("into", [("box_head", "weak_box_head"), ("box_head",), ("weak_box_head",), ()])
def test_load_torch_resnet_matches_unit_tpu_leaf_by_leaf(msra_state_dict, into):
    golden = np.load(GOLDEN)
    x, pooled = jnp.asarray(golden["x"]), jnp.asarray(golden["pooled"])
    jb = JResNetC4(depth=26, res2_out_channels=32, dtype=jnp.float32)
    j5 = JRes5(depth=26, res2_out_channels=32, dtype=jnp.float32)
    params = {"backbone": jb.init(jax.random.PRNGKey(0), x)["params"],
              "box_head": j5.init(jax.random.PRNGKey(1), pooled)["params"],
              "weak_box_head": j5.init(jax.random.PRNGKey(2), pooled)["params"]}
    want, jloaded, jskipped = jload_torch_resnet(params, msra_state_dict, load_res5_into=into)
    want = flatten_tree(want)
    before = flatten_tree(jax.tree.map(np.asarray, params))

    model = Heads()
    fresh = {n: t.detach().clone() for n, t in
             list(model.named_parameters()) + list(model.named_buffers())}
    _, loaded, skipped = load_torch_resnet(model, msra_state_dict, load_res5_into=into)
    assert (loaded, len(skipped)) == (jloaded, len(jskipped))
    n_set = 0
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        path = flax_path(name, t)
        if np.array_equal(want[path], before[path]):  # unit_tpu left it untouched
            assert torch.equal(t, fresh[name]), name
        else:
            np.testing.assert_array_equal(to_flax_layout(t.detach().numpy()), want[path], path)
            n_set += 1
    assert n_set == loaded


def test_shape_mismatches_are_skipped_not_loaded():
    model = Heads()
    w0 = model.backbone.stem_conv1.weight.detach().clone()
    _, loaded, skipped = load_torch_resnet(
        model, {"stem.conv1.weight": np.zeros((8, 3, 7, 7), np.float32),
                "res9.0.conv1.weight": np.zeros(3, np.float32),
                "stem.conv1.norm.bias": np.full(64, 2.0, np.float32)}, load_res5_into=())
    assert loaded == 1 and len(skipped) == 2 and "shape" in skipped[0]
    assert torch.equal(model.backbone.stem_conv1.weight, w0)
    assert bool((model.backbone.stem_conv1_bn.bias == 2).all())


def test_merge_from_own_checkpoint_is_tolerant(tmp_path):
    t, _, _ = tiny_trainer()
    t.train(1)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.maybe_save_best(1, 12.0, t.state)
    fresh, _, _ = tiny_trainer()
    model = fresh.model
    # a head of another shape and a tensor the checkpoint lacks keep their init
    model.rpn_head.conv.weight = nn.Parameter(torch.zeros(3, 3, 3, 3))
    model.register_buffer("extra", torch.ones(2))
    _, loaded, skipped = merge_params_from_checkpoint(model, str(tmp_path / "best"))
    assert loaded == len(t.model.state_dict()) - 1
    assert len(skipped) == 1 and "rpn_head.conv.weight (shape" in skipped[0]
    assert torch.equal(model.supervised.cls_score_delta.weight,
                       t.model.supervised.cls_score_delta.weight)
    assert bool((model.extra == 1).all() and (model.rpn_head.conv.weight == 0).all())
