"""The registry, the cyclic cosine schedule and the TensorBoard writer of
unit_tpu_torch against unit_tpu's (utils/registry.py,
solver/lr_scheduler.py, utils/events.py).

  * Registry: the same behaviour and the same errors for a duplicate and an
    unknown name; BACKBONE_REGISTRY holds unit_tpu's names and aliases,
    BOX_HEAD_REGISTRY unit_tpu's and the Res5 names unit_tpu builds without
    its registry; a backbone a user registers builds a WSRCNN;
  * cyclic_cosine_decay: unit_tpu's schedule (f32) at sampled steps through
    the warm-up, the first decay, fixed and growing restart cycles, to 1e-6
    relative (min_decay_lr is a quarter of base_lr, so f32's ~1e-7 rounding
    of the cosine stays under it) plus 1e-7 x base_lr absolute (a warm-up
    from 0 starts at 1 + cos(x) with x near pi); no sample sits on a cycle
    boundary, where f32 and f64 may floor the cycle index apart; and the
    schedule as a LambdaLR factor;
  * TensorBoardWriter: event files under ``<output_dir>/tb`` when
    torch.utils.tensorboard imports, a writer that writes nothing when not.
"""

import dataclasses
import glob
import math
import sys

import numpy as np
import pytest
import torch

from unit_tpu.models import backbones as jbackbones
from unit_tpu.models import box_heads as jbox_heads
from unit_tpu.solver.lr_scheduler import cyclic_cosine_decay as jcyclic
from unit_tpu.utils.registry import Registry as JRegistry
from unit_tpu_torch.models import WSRCNN
from unit_tpu_torch.models.backbones import BACKBONE_REGISTRY
from unit_tpu_torch.models.box_heads import BOX_HEAD_REGISTRY
from unit_tpu_torch.models.resnet import ResNetC4
from unit_tpu_torch.solver import cyclic_cosine_decay
from unit_tpu_torch.utils import events
from unit_tpu_torch.utils.registry import Registry


def exercise(cls):
    """What a registry does and the messages of its errors."""
    reg = cls("THING")

    @reg.register()
    def alpha():
        return "a"

    reg.register(lambda: "b", name="beta")

    @reg.register(name="gamma")
    class Gamma:
        pass

    errors = []
    for bad in (lambda: reg.register(alpha), lambda: reg.get("delta")):
        with pytest.raises(KeyError) as info:
            bad()
        errors.append(str(info.value))
    return (sorted(reg.keys()), [k for k, _ in reg], "beta" in reg, "delta" in reg,
            reg.get("alpha")(), reg.get("beta")(), reg.get("gamma").__name__, errors)


def test_registry_behaves_as_unit_tpus():
    got, want = exercise(Registry), exercise(JRegistry)
    assert got == want
    assert got[0] == ["alpha", "beta", "gamma"]


def test_the_registries_hold_unit_tpus_names():
    assert set(BACKBONE_REGISTRY.keys()) == set(jbackbones.BACKBONE_REGISTRY.keys())
    jheads = set(jbox_heads.BOX_HEAD_REGISTRY.keys())
    assert jheads <= set(BOX_HEAD_REGISTRY.keys())
    # the Res5 heads unit_tpu builds in meta_arch, outside its registry
    assert set(BOX_HEAD_REGISTRY.keys()) - jheads == {
        "Res5BoxHead", "Res5BoxHeadWithMask", "Res5BoxHeadNOTE", ""}
    # aliases name the same builders, as unit_tpu's do
    for alias, name in (("VGG", "build_vgg_backbone"), ("VGG_CNN_F", "build_vgg_cnn_f_backbone"),
                        ("InceptionResNetV2", "build_inception_resnet_v2_backbone")):
        assert BACKBONE_REGISTRY.get(alias) is BACKBONE_REGISTRY.get(name)
        assert jbackbones.BACKBONE_REGISTRY.get(alias) is jbackbones.BACKBONE_REGISTRY.get(name)
    with pytest.raises(KeyError, match="No object named 'ResNeXt' found in 'BACKBONE'"):
        BACKBONE_REGISTRY.get("ResNeXt")


def test_a_registered_backbone_builds_a_wsrcnn():
    from tests.test_torch_overfit import tiny_config

    made = []

    @BACKBONE_REGISTRY.register(name="TinyUserResNet")
    def tiny_user_resnet(depth=50, res2_out_channels=256, dtype=torch.float32,
                         generator=None, **_):
        made.append((depth, res2_out_channels))
        return ResNetC4(depth=depth, res2_out_channels=res2_out_channels, dtype=dtype,
                        generator=generator)

    try:
        mc = dataclasses.replace(tiny_config(), backbone_name="TinyUserResNet")
        model = WSRCNN(mc, generator=torch.Generator().manual_seed(0)).eval()
        assert made == [(26, 256)] and isinstance(model.backbone, ResNetC4)
        with torch.inference_mode():
            dets = model.predict(torch.rand(1, 64, 96, 3) * 255, torch.tensor([[64.0, 90.0]]))
        assert bool(torch.isfinite(dets.boxes).all())
    finally:
        BACKBONE_REGISTRY._obj_map.pop("TinyUserResNet")


SCHEDULES = [
    # (kwargs, steps): warm-up and the first decay only
    (dict(base_lr=0.02, init_decay_epochs=300, min_decay_lr=0.005, warmup_epochs=40,
          warmup_start_lr=0.001), [0, 1, 7, 20, 39, 40, 41, 100, 211, 339, 340, 500, 2000]),
    # fixed restart cycles of 100 after 300 steps, restarting at restart_lr
    (dict(base_lr=0.02, init_decay_epochs=300, min_decay_lr=0.005, restart_interval=100,
          restart_lr=0.012), [0, 150, 299, 301, 333, 399, 401, 450, 777, 1234]),
    # growing cycles (100, 200, 400, ...: restarts at 100, 300, 700, 1500 past
    # the first decay), after a 50-step warm-up from 0
    (dict(base_lr=0.1, init_decay_epochs=200, min_decay_lr=0.025, restart_interval=100,
          restart_interval_multiplier=2.0, warmup_epochs=50),
     [0, 10, 49, 50, 123, 251, 330, 349, 351, 420, 549, 551, 800, 949, 951, 1600, 2100]),
]


@pytest.mark.parametrize("kwargs,steps", SCHEDULES)
def test_cyclic_cosine_decay_matches_unit_tpu(kwargs, steps):
    ours, theirs = cyclic_cosine_decay(**kwargs), jcyclic(**kwargs)
    got = [ours(s) for s in steps]
    want = [float(theirs(s)) for s in steps]
    # 1e-6 relative; near the warm-up's start from 0 the value is 1 + cos(x)
    # with x near pi, where unit_tpu's f32 cosine leaves ~1e-8 absolute
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * kwargs["base_lr"])
    assert all(isinstance(v, float) for v in got)
    assert len({round(v, 9) for v in got}) >= 6  # the samples span the schedule


def test_cyclic_cosine_decay_as_a_lambda_lr_factor():
    kwargs, _ = SCHEDULES[2]
    schedule = cyclic_cosine_decay(**kwargs)
    param = torch.nn.Parameter(torch.zeros(()))
    opt = torch.optim.SGD([param], lr=kwargs["base_lr"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: schedule(k) / kwargs["base_lr"])
    for k in range(400):
        assert math.isclose(opt.param_groups[0]["lr"], schedule(k), rel_tol=1e-12), k
        opt.step()
        sched.step()


def run_hook(tmp_path, tensorboard):
    hook = events.MetricsHook(str(tmp_path), period=2, max_iter=4, tensorboard=tensorboard,
                              lr_fn=lambda s: 0.1 * s)
    for step in range(1, 5):
        hook(step, {"total_loss": 1.0 / step, "loss_cls": 0.5 / step}, trainer=None)
    hook.close()
    return hook


def test_tensorboard_writer_writes_event_files(tmp_path):
    hook = run_hook(tmp_path, tensorboard=True)
    assert isinstance(hook.writers[-1], events.TensorBoardWriter)
    files = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1 and (tmp_path / "tb").is_dir()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(files[0])
    acc.Reload()
    assert {"total_loss", "loss_cls", "lr"} <= set(acc.Tags()["scalars"])
    assert [e.step for e in acc.Scalars("total_loss")] == [2, 4]
    assert [round(e.value, 6) for e in acc.Scalars("total_loss")] == [0.5, 0.25]
    # the writer is off unless asked for, as in unit_tpu
    assert not any(isinstance(w, events.TensorBoardWriter)
                   for w in run_hook(tmp_path / "off", tensorboard=False).writers)


def test_tensorboard_writer_writes_nothing_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    # the package logger may not propagate (the runner's setup_logger): read
    # the warning at the call
    warned = []
    monkeypatch.setattr(events.logger, "warning", lambda msg, *a: warned.append(msg % a))
    hook = run_hook(tmp_path, tensorboard=True)
    assert hook.writers[-1]._w is None
    assert any("does not import" in w for w in warned)
    assert not (tmp_path / "tb").exists()
    assert (tmp_path / "metrics.json").read_text().count("\n") == 2
