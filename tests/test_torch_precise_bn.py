"""PreciseBN (TEST.PRECISE_BN): unit_tpu_torch vs unit_tpu.

The model is the flagship recipe cut to depth 26 and RES2_OUT_CHANNELS 16,
with seeded flax weights carried across by load_jax_params; batches are 2
seeded images of 64 x 96.

Bounds, each with its reason:
  * one FrozenBN's captured statistics: f32 to 4e-6 of the largest value
    (a mean and a variance of 70 values in different summation orders),
    bf16 bit-identical (both round an f32 result once);
  * the refreshed statistics in f32: 1e-6 of each layer's largest value
    (the backbone's f32 convolutions differ in summation order);
  * in bf16 the two backbones differ by about one bf16 rounding per
    FrozenBN (models/resnet.py: the port rounds its fused epilogue once),
    so their statistics agree to 2^-5 of each layer's largest value (4 bf16
    ulps); the averaging itself (R8: the per-batch statistics summed in bf16,
    rounding at each addition, then divided in f32) is held bit for bit on
    the same per-batch statistics;
  * every other tensor of the model, the Res5 heads' FrozenBN buffers
    included: bit-identical to before.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.utils.precise_bn as jpbn
import unit_tpu_torch.data as tdata
import unit_tpu_torch.utils.precise_bn as tpbn
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import seeded_image_loader, write_devkit
from tests.test_torch_runner import TINY, FLAGSHIP
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.models.resnet import FrozenBN as JFrozenBN
from unit_tpu_torch.checkpoint import load_jax_params, read_checkpoint
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine import runner
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models.resnet import FrozenBN

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_REL = 1e-6
BF16_REL = 2.0 ** -5


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_frozen_bn_capture_matches_the_sow(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(0).randn(2, 5, 7, 16).astype(np.float32) * 3 + 1
    jbn = JFrozenBN(16, dtype=jdt)
    jx = jnp.asarray(x).astype(jdt)
    _, aux = jbn.apply(jbn.init(jax.random.PRNGKey(0), jx), jx, mutable=["bn_stats"])
    want = [np.asarray(aux["bn_stats"][k][0]) for k in ("batch_mean", "batch_var")]
    bn = FrozenBN(16, dtype=tdt)
    bn.mean.fill_(0.5)  # the statistics are those of the input, before the buffers apply
    assert bn.batch_stats is None
    tx = torch.as_tensor(x).to(tdt).permute(0, 3, 1, 2)  # NCHW, channels_last memory
    assert tx.is_contiguous(memory_format=torch.channels_last)
    bn.batch_stats = []
    y = bn(tx)
    assert len(bn.batch_stats) == 1 and torch.equal(y, FrozenBN.forward(bn.eval(), tx))
    for got, w in zip(bn.batch_stats[0], want):
        assert got.dtype == tdt and got.shape == (16,)
        if dtype == "float32":
            assert np.abs(got.numpy() - w).max() <= 4e-6 * np.abs(w).max()
        else:
            np.testing.assert_array_equal(got.float().numpy(), w.astype(np.float32))


def cfgs(dtype):
    jcfg, tcfg = jget_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(FLAGSHIP)
        cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
                             "TPU.COMPUTE_DTYPE", dtype])
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def jax_model(dtype):
    jmodel = JWSRCNN(mc=JModelConfig.from_cfg(cfgs(dtype)[0]))
    params = randomize_params(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64.0, 64.0]]))["params"],
        seed=3)
    return jmodel, params


def pair(dtype):
    """unit_tpu's model (made once a dtype) and a fresh port model on its weights."""
    jmodel, params = jax_model(dtype)
    tmodel = WSRCNN(ModelConfig.from_cfg(cfgs(dtype)[1])).eval()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def batches(n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [{"image": rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)} for _ in range(n)]


def is_stat(name):
    return name.endswith(".mean") or name.endswith(".var")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_precise_bn_matches_and_touches_nothing_else(dtype):
    jmodel, params, tmodel = pair(dtype)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    want = flatten_tree(jax.tree.map(np.asarray, jpbn.precise_bn(
        jmodel, params, iter(batches()), num_iters=3)))
    assert tpbn.precise_bn(tmodel, iter(batches()), num_iters=3) is tmodel
    refreshed = 0
    for name, got in tmodel.state_dict().items():
        if is_stat(name) and name.startswith("backbone."):
            w = want[name.replace(".", "/")]
            rel = F32_REL if dtype == "float32" else BF16_REL
            assert got.dtype == torch.float32
            assert np.abs(got.numpy() - w).max() <= rel * np.abs(w).max(), name
            assert not torch.equal(got, before[name]), name
            refreshed += 1
        else:  # parameters, embeddings, the Res5 heads' FrozenBN buffers
            assert torch.equal(got, before[name]), name
    assert refreshed == 2 * sum(isinstance(m, FrozenBN) for m in tmodel.backbone.modules())


def test_precise_bn_averages_in_the_activation_dtype_as_unit_tpu_does(monkeypatch):
    """R8: both packages fed the same 16 per-batch bf16 statistics (batch k
    is an image filled with k, which selects them) give the same buffers,
    bit for bit, and those differ from the exact f32 mean."""
    jmodel, params, tmodel = pair("bfloat16")
    real = [tpbn.collect_bn_stats(tmodel, torch.as_tensor(b["image"])) for b in batches(16)]
    names = sorted(real[0])
    table = {n: [torch.stack([s[n][i] for s in real]) for i in (0, 1)] for n in names}

    def port_stats(model, images):
        k = int(images[0, 0, 0, 0])
        return {n: (table[n][0][k], table[n][1][k]) for n in names}

    def jax_stats(model, params, images):
        k = images[0, 0, 0, 0].astype(jnp.int32)
        tree = {}
        for n in names:
            node = tree
            for part in n.split("."):
                node = node.setdefault(part, {})
            for key, i in (("batch_mean", 0), ("batch_var", 1)):
                values = jnp.asarray(table[n][i].float().numpy()).astype(jnp.bfloat16)
                node[key] = (values[k],)
        return tree

    monkeypatch.setattr(tpbn, "collect_bn_stats", port_stats)
    monkeypatch.setattr(jpbn, "collect_bn_stats", jax_stats)
    fill = [{"image": np.full((1, 32, 32, 3), k, np.float32)} for k in range(16)]
    want = flatten_tree(jax.tree.map(np.asarray, jpbn.precise_bn(jmodel, params, iter(fill), 16)))
    tpbn.precise_bn(tmodel, iter(fill), 16)
    sd, moved = tmodel.state_dict(), 0
    for n in names:
        for i, stat in enumerate(("mean", "var")):
            got = sd[f"{n}.{stat}"]
            np.testing.assert_array_equal(got.numpy(), want[f"{n}/{stat}".replace(".", "/")])
            exact = table[n][i].float().mean(0)
            moved += int((got != exact).sum())
    assert moved > 0  # the bf16 sum lost precision somewhere


def test_zero_batches_leave_the_model_unchanged():
    tmodel = WSRCNN(ModelConfig.from_cfg(cfgs("float32")[1]),
                    generator=torch.Generator().manual_seed(0)).eval()
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tpbn.precise_bn(tmodel, iter([]), num_iters=4)
    tpbn.precise_bn(tmodel, iter(batches()), num_iters=0)
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    assert all(m.batch_stats is None for m in tmodel.modules() if isinstance(m, FrozenBN))


def test_the_hook_refreshes_before_the_checkpoint_and_closes_its_loader(tmp_path, monkeypatch):
    devkit = write_devkit(tmp_path / "VOCdevkit", n_images=4)
    refreshed = []
    real = runner.precise_bn

    def recording(model, loader, num_iter):
        before = {k: v.clone() for k, v in model.state_dict().items() if is_stat(k)}
        out = real(model, loader, num_iter)
        refreshed.append(({k: v.clone() for k, v in model.state_dict().items() if is_stat(k)},
                          before))
        return out

    monkeypatch.setattr(runner, "precise_bn", recording)
    args = runner.default_argument_parser().parse_args([
        "--config-file", FLAGSHIP, "--device", "cpu", "--data-root", devkit, *TINY,
        "DATASETS.CLASSIFIER_DATAROOT", devkit, "OUTPUT_DIR", str(tmp_path / "out"),
        "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2",
        "TEST.PRECISE_BN.ENABLED", "True", "TEST.PRECISE_BN.NUM_ITER", "2"])
    tdata.DatasetCatalog.clear()
    results = runner.run(args, image_loader=seeded_image_loader)
    assert np.isfinite(results["bbox"]["AP50"])
    (after, before), = refreshed  # one period, at step 2
    saved = read_checkpoint(str(tmp_path / "out" / "step_2.pt"))["model"]
    backbone = [k for k in after if k.startswith("backbone.")]
    assert backbone and all(torch.equal(saved[k], after[k]) for k in after)
    assert all(not torch.equal(after[k], before[k]) for k in backbone)
    alive = [t for t in threading.enumerate() if "_prefetch_worker" in t.name and t.is_alive()]
    assert not alive, alive
