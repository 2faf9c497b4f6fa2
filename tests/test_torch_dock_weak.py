"""The weak detector's regression branches and OICR_ITER 0: port vs unit_tpu.

No shipped recipe sets WEAK_DETECTOR.REGRESSION_BRANCH,
OICR_REGRESSION_BRANCH or OICR_ITER 0, but unit_tpu supports them beside the
dock recipe (ROADMAP item 25a).  Held here against
unit_tpu/models/predictors.py and unit_tpu/models/weak_losses.py on shared
weights and seeded numpy inputs: the heads' training streams and inference
scores, the supervised bbox delta's zero init under the branch, the
regression branch's losses (L1 and smooth L1) and their gradients, the
OICR_ITER 0 loss dict and the background column the combination pads.

Bounds: tests/test_torch_heads.py's atol 1e-5 for head outputs (f32 over at
most a few hundred terms), tests/test_torch_losses.py's rtol 1e-5 for losses,
gradients within 1e-5 of the leaf's largest element (tighter than 1e-3:
these are sums of a few hundred f32 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_heads import ATOL, D, random_tree
from tests.test_torch_losses import RTOL, C, weak_inputs
from unit_tpu.models import predictors as jpred
from unit_tpu.models import weak_losses as jweak
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models import predictors as tpred
from unit_tpu_torch.models import weak_losses as tweak

GRAD_REL = 1e-5


def t(x):
    return torch.as_tensor(np.asarray(x))


def pair(x, **kw):
    jm = jpred.WeakDetectorPredictor(num_classes=C, detector_temp=2.0, **kw)
    params = random_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    tm = load_jax_params(tpred.WeakDetectorPredictor(D, C, detector_temp=2.0, **kw), params)
    return jm, params, tm


@pytest.mark.parametrize("kw", [dict(regression_branch=True),
                                dict(oicr_regression_branch=True),
                                dict(regression_branch=True, oicr_regression_branch=True),
                                dict(oicr_iter=0)],
                         ids=["branch", "oicr_regressors", "both", "oicr_iter_0"])
def test_weak_detector_heads_match_unit_tpu(kw):
    """Training streams and inference scores: the regression branch scores
    at inference where it is on ([1, N, C+1] and its deltas), else the OICR
    heads with the mean of their regressors' deltas, else (OICR_ITER 0) the
    MIL classifier stream over its temperature, [1, N, C], and zero deltas."""
    x = np.random.RandomState(7).randn(13, D).astype(np.float32)
    jm, params, tm = pair(x, **kw)
    if kw.get("oicr_regression_branch"):
        assert params["oicr_regressor_2"]["kernel"].shape == (D, 4 * C)
    want = jm.apply({"params": params}, jnp.asarray(x))
    want_cls, want_bbox = jm.apply({"params": params}, jnp.asarray(x),
                                   method=jpred.WeakDetectorPredictor.evaluation)
    with torch.no_grad():
        got = tm(t(x))
        got_cls, got_bbox = tm.evaluation(t(x))
    for k in ("classifier_stream", "detection_stream", "regression_cls", "regression_bbox"):
        if want[k] is None:  # a stream the port's heads do not have
            assert k not in got, k
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)
    for name in ("oicr_scores", "oicr_bbox"):
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert got_cls.shape == want_cls.shape
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=ATOL)
    np.testing.assert_allclose(got_bbox.numpy(), np.asarray(want_bbox), atol=ATOL)
    assert np.abs(np.asarray(want_bbox)).max() > 0 or not (
        kw.get("regression_branch") or kw.get("oicr_regression_branch"))


def test_combine_pads_the_missing_background_column():
    rng = np.random.RandomState(3)
    delta, weak = rng.randn(6, C + 1).astype(np.float32), rng.randn(1, 6, C).astype(np.float32)
    want = jpred.combine_cls_logits(jnp.asarray(delta), jnp.asarray(weak))
    got = tpred.combine_cls_logits(t(delta), t(weak))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got[:, -1].numpy(), delta[:, -1])


def test_supervised_bbox_delta_starts_at_zero_under_the_branch():
    for branch in (False, True):
        tm = tpred.SupervisedPredictor(D, C, regression_branch=branch,
                                       generator=torch.Generator().manual_seed(0))
        assert bool(tm.bbox_pred_delta.weight.any()) == (not branch)


def regression_inputs(seed):
    props, valid, labels, streams = weak_inputs(seed=seed)
    rng = np.random.RandomState(seed + 100)
    n = props.shape[0] * props.shape[1]
    streams["regression_cls"] = rng.randn(n, C + 1).astype(np.float32)
    streams["regression_bbox"] = (rng.randn(n, 4 * C) * 0.5).astype(np.float32)
    return props, valid, labels, streams


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_regression_branch_losses_and_gradients_match(beta):
    """loss_regression_cls / _bbox against pseudo boxes mined from the mean
    of the OICR softmaxes, beside the MIL and OICR losses; and the gradient
    of the total with respect to every stream."""
    props, valid, labels, streams = regression_inputs(11)
    kw = dict(num_classes=C, regression_branch=True, smooth_l1_beta=beta,
              weak_loss_multiplier=0.5, bbox_reg_weights=(10.0, 10.0, 5.0, 5.0))

    def jtotal(s):
        losses = jweak.weak_detector_losses(s, jnp.asarray(props), jnp.asarray(valid),
                                            jnp.asarray(labels), jweak.WeakLossConfig(**kw))
        return sum(losses.values()), losses

    js = jax.tree.map(jnp.asarray, streams)
    (_, want), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(js)
    ts = {k: ([t(v).requires_grad_(True) for v in vs] if isinstance(vs, list)
              else t(vs).requires_grad_(True)) for k, vs in streams.items()}
    got = tweak.weak_detector_losses(ts, t(props), t(valid), t(labels),
                                     tweak.WeakLossConfig(**kw))
    assert set(got) == set(want) and {"loss_regression_cls", "loss_regression_bbox"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=RTOL, err_msg=k)
    assert float(got["loss_regression_bbox"].detach()) > 0
    torch.stack(list(got.values())).sum().backward()
    for k, vs in ts.items():
        for i, v in enumerate(vs if isinstance(vs, list) else [vs]):
            jg = np.asarray(jgrads[k][i] if isinstance(vs, list) else jgrads[k])
            assert np.abs(v.grad.numpy() - jg).max() <= GRAD_REL * np.abs(jg).max() + 1e-9, k
    assert np.abs(ts["regression_bbox"].grad.numpy()).max() > 0


def test_oicr_iter_0_keeps_the_mil_loss_alone():
    props, valid, labels, streams = weak_inputs(seed=12)
    streams["oicr_scores"] = []
    kw = dict(num_classes=C, oicr_iter=0)
    want = jweak.weak_detector_losses(jax.tree.map(jnp.asarray, streams), jnp.asarray(props),
                                      jnp.asarray(valid), jnp.asarray(labels),
                                      jweak.WeakLossConfig(**kw))
    got = tweak.weak_detector_losses({k: ([] if k == "oicr_scores" else t(v))
                                      for k, v in streams.items()},
                                     t(props), t(valid), t(labels), tweak.WeakLossConfig(**kw))
    assert set(got) == set(want) == {"loss_im_cls"}
    np.testing.assert_allclose(float(got["loss_im_cls"]), float(want["loss_im_cls"]), rtol=RTOL)


@pytest.mark.parametrize("opts", [
    ["MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.REGRESSION_BRANCH", "True"],
    ["MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.OICR_REGRESSION_BRANCH", "True"],
    ["MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.OICR_ITER", "0"]],
    ids=["branch", "oicr_regressors", "oicr_iter_0"])
def test_the_options_build_a_model_with_unit_tpus_leaves(opts):
    """The model's parameters under each option are unit_tpu's leaves (by
    name and shape) on the weak detector and the supervised head, and its
    config carries the ROI_BOX_HEAD regression settings into the losses."""
    from unit_tpu.config import get_cfg as jget_cfg
    from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
    from unit_tpu.models.meta_arch import ModelConfig as JModelConfig

    jcfg, tcfg = jget_cfg(), get_cfg()
    small = ["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
             "MODEL.ROI_HEADS.MULTI_BOX_HEAD", "False"]
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
        cfg.merge_from_list(small + opts + ["MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA", "0.25"])
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[64.0, 64.0]]))["params"]
    tm = WSRCNN(ModelConfig.from_cfg(tcfg))
    want = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()
        if k.split("/")[0] in ("weak_detector", "supervised")}
    load_jax_params(tm, jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    got = {n.replace(".", "/").replace("weight", "kernel"): tuple(p.shape[::-1])
           for n, p in tm.named_parameters() if n.split(".")[0] in ("weak_detector", "supervised")}
    assert set(got) == set(want)
    assert tm.mc.weak.smooth_l1_beta == 0.25
    assert tm.mc.weak.regression_branch == (opts[0].endswith(".REGRESSION_BRANCH"))
