"""Data parallelism of unit_tpu_torch against unit_tpu, on the CPU.

unit_tpu's data parallelism is one jitted step over a device mesh (the
conftest's 8 fake CPU devices); the port's is one process a rank, two ranks
here over gloo (``parallel.launch``; the ranks' functions live in the
jax-free tests/test_torch_parallel_run.py, whose ``spawn`` bounds each
launch by a timeout).  The same seeded numpy inputs go through both:

  * the step (the core): the small flagship in the keep-everything regime of
    tests/test_torch_losses.py on a global batch of 4 + 4 images.
    unit_tpu's ``make_train_step(mesh=make_mesh(2))`` on the sharded batch
    against the port at world 2, each rank given its half, from the same
    weights: the losses to rtol 1e-4 and each leaf's update to
    2e-3 * max|update_jax| + 1e-9 (tests/test_torch_train.py's bounds).  The
    halves carry unequal valid-ROI counts (other GT slots valid), and the
    same step with a rank-local count in the fast R-CNN loss misses those
    bounds: the global normaliser is what makes the step match.  After 3
    steps the ranks' parameters are bit-identical;
  * accumulation: world 2 at TPU.GRAD_ACCUM 2 against one process at
    GRAD_ACCUM 2 whose micro-batches are both ranks' micro-batches together;
  * the batch-spanning losses one by one (fast R-CNN, mask, the rank losses
    of the visual attention head) at world 2, with unequal counts a rank,
    against unit_tpu's function on the whole batch: the ranks' mean loss,
    and each rank's input gradient over the world;
  * the loaders: for each of 2 shards, the port's ``StreamLoader`` with the
    orientation schedule the ranks share against unit_tpu's (12 batches by
    images and record ids, ``fast_forward``, a shard without an orientation,
    a square canvas), and every split loader built at world 2 against
    unit_tpu's built as process r of 2;
  * gathered evaluation: VOC and COCO evaluators fed half the images a rank
    and merged equal the single pass and unit_tpu's evaluator on the whole
    set exactly.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import unit_tpu.data as jdata
import unit_tpu.data.loader as jloader
from tests.test_torch_losses import jax_params, train_batches
from tests.test_torch_parallel_run import (
    FLAGSHIP, LOADER_OPTS, SMALL_OPTS, STREAM_BATCHES, DEVKIT_SIZES, coco_feed, rank_evaluate,
    rank_accumulate, rank_loaders, rank_losses, rank_train, seeded_image_loader, spawn,
    voc_feed)
from tests.test_torch_parallel_run import four_threads  # noqa: F401  (autouse)
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.engine.train import TrainState as JTrainState
from unit_tpu.engine.train import make_train_step as jmake_train_step
from unit_tpu.evaluation.coco_eval import COCOEvaluator as JCOCOEvaluator
from unit_tpu.evaluation.voc_eval import PascalVOCEvaluator as JVOCEvaluator
from unit_tpu.parallel import make_mesh, replicate, shard_batch
from unit_tpu.solver import build_optimizer as jbuild_optimizer
from unit_tpu_torch.checkpoint import flax_leaves, load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data import loader as tloader
from unit_tpu_torch.engine import TrainerNoMeta
from unit_tpu_torch.evaluation.coco_eval import COCOEvaluator
from unit_tpu_torch.evaluation.voc_eval import PascalVOCEvaluator
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

LOSS_RTOL = 1e-4
UPDATE_REL, UPDATE_ATOL = 2e-3, 1e-9


def jax_cfg():
    cfg = jget_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS)
    return cfg


def global_batch(seed):
    """4 strong + 4 weak images: two of tests/test_torch_losses.py's 2-image
    batches, the second half with fewer valid GT slots (3 + 3 against 1 + 2),
    so that the halves count different valid ROIs."""
    (s0, w0), (s1, w1) = train_batches(seed=seed), train_batches(seed=seed + 1)
    s1["gt_valid"] = np.asarray([[True, False, False, False], [True, True, False, False]])
    return ({k: np.concatenate([s0[k], s1[k]]) for k in s0},
            {k: np.concatenate([w0[k], w1[k]]) for k in w0})


def worst_update(got, want):
    """max over the port's parameters of |got - want| / (2e-3 * max|want| +
    1e-9) (unit_tpu's tree also holds the FrozenBN statistics, buffers here)."""
    return max(np.abs(got[p] - want[p]).max() / (UPDATE_REL * np.abs(want[p]).max()
                                                 + UPDATE_ATOL) for p in got)


def worst_loss(got, want):
    return max(abs(got[k] - v) / abs(v) for k, v in want.items())


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """unit_tpu's 2-device mesh step and the port's world-2 run (rank_train)."""
    cfg = jax_cfg()
    jm, params = jax_params(cfg)
    before = flatten_tree(jax.tree.map(np.asarray, params))
    strong, weak = global_batch(1)
    mesh = make_mesh(2)
    tx = jbuild_optimizer(cfg, params)
    state = replicate(mesh, JTrainState(params=params, opt_state=tx.init(params),
                                        step=jnp.zeros((), jnp.int32)))
    new_state, metrics = jmake_train_step(jm, tx, mesh=mesh)(
        state, shard_batch(mesh, strong), shard_batch(mesh, weak), None, jax.random.PRNGKey(0))
    after = flatten_tree(jax.tree.map(np.asarray, jax.device_get(new_state.params)))
    want = {k: after[k] - before[k] for k in before}
    micro = [global_batch(3), global_batch(5)]
    rdzv = tmp_path_factory.mktemp("rdzv")
    ranks = spawn(rdzv, rank_train, before, strong, weak)
    accum = spawn(rdzv, rank_accumulate, before, [s for s, _ in micro], [w for _, w in micro])
    for r, a in zip(ranks, accum):
        r["accum"] = a
    return ({k: float(v) for k, v in metrics.items()}, want, before, micro, ranks)


def test_world_two_step_matches_unit_tpus_mesh_step(steps):
    jax_metrics, want, _, _, (a, b) = steps
    assert all(a["metrics"][0][k] == b["metrics"][0][k] for k in jax_metrics)  # global losses
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(a["metrics"][0][k], v, rtol=LOSS_RTOL, err_msg=k)
    assert worst_update(a["update"], want) <= 1.0
    frozen = [p for p in a["update"] if p.startswith(("backbone/stem", "backbone/res2"))]
    assert frozen and all(not a["update"][p].any() for p in frozen)
    assert all(np.abs(want[p]).max() > 0 for p in a["update"] if p not in frozen)


def test_the_halves_count_different_valid_rois(steps):
    *_, (a, b) = steps
    (na,), (nb,) = a["counts"], b["counts"]
    assert na != nb, (na, nb)


def test_a_rank_local_count_misses_the_bounds(steps):
    """The same step with each rank dividing its fast R-CNN losses by its own
    valid-slot count: the gradient is not the global batch's any more."""
    jax_metrics, want, *_, (a, b) = steps
    metrics, update = a["local"]
    loss_off = worst_loss({k: metrics[k] for k in ("loss_cls", "loss_box_reg")},
                          {k: jax_metrics[k] for k in ("loss_cls", "loss_box_reg")})
    update_off = worst_update(update, want)
    print(f"rank-local count: loss_cls/loss_box_reg off by {loss_off:.3g} (rtol "
          f"{LOSS_RTOL}), updates at {update_off:.3g} x the bound")
    assert loss_off > LOSS_RTOL or update_off > 1.0


def test_ranks_are_bit_identical_after_three_steps(steps):
    *_, (a, b) = steps
    assert len(a["metrics"]) == 3 and a["digest"] == b["digest"]
    assert [m["total_loss"] for m in a["metrics"]] == [m["total_loss"] for m in b["metrics"]]


def test_accumulation_at_world_two_equals_one_process(steps):
    _, _, before, micro, (a, b) = steps
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(SMALL_OPTS + ["TPU.GRAD_ACCUM", "2"])
    model = WSRCNN(ModelConfig.from_cfg(cfg))
    load_jax_params(model, before)
    start = flax_leaves(model)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), iter([s for s, _ in micro]),
                            iter([w for _, w in micro]), seed=0, grad_accum=2)
    trainer.init_state()
    metrics = trainer.run_step()
    want = {k: v - start[k] for k, v in flax_leaves(model).items()}
    got_metrics, got = a["accum"]
    for k, v in metrics.items():
        if k != "data_time":
            np.testing.assert_allclose(got_metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert worst_update(got, want) <= 1.0
    assert b["accum"][0]["total_loss"] == got_metrics["total_loss"]


# ------------------------------------------------------- the batch-spanning losses
@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    from tests.test_torch_losses import BASE, C, NOVEL, boxes
    from tests.test_torch_mask import mask_case
    from tests.test_torch_visual_attention import BASE as VA_BASE
    from tests.test_torch_visual_attention import NUM_CLASSES, query_inputs, support_inputs
    from tests.test_full_graph_torch_parity import randomize_params
    from unit_tpu.models import fast_rcnn as jfrcnn
    from unit_tpu.models import mask_head as jmask
    from unit_tpu.models.visual_attention import VisualAttentionHead as JHead
    from unit_tpu.structures.instances import SampledProposals as JSampled

    rng = np.random.RandomState(8)
    n = 60
    valid = np.concatenate([rng.rand(n // 2) > 0.2, rng.rand(n // 2) > 0.6])  # unequal halves
    fields = dict(boxes=boxes(rng, n), gt_boxes=boxes(rng, n),
                  gt_classes=rng.choice(BASE + (C,), n).astype(np.int32), valid=valid)
    fields["is_fg"] = (fields["gt_classes"] < C) & valid
    fields["gt_index"] = np.zeros(n, np.int32)
    scores = rng.randn(n, C + 1).astype(np.float32) * 3
    scores[:, list(NOVEL)] = -1e9
    deltas = rng.randn(n, C * 4).astype(np.float32)
    cfg = jfrcnn.FastRCNNConfig(num_classes=C)

    def frcnn_loss(s, d):
        out = jfrcnn.fast_rcnn_losses(s, d, JSampled(**{k: jnp.asarray(v)
                                                        for k, v in fields.items()}), cfg)
        return sum(out.values()), out

    (_, fr_want), fr_grads = jax.value_and_grad(frcnn_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(scores), jnp.asarray(deltas))
    masks, gt, roi, classes, fg = mask_case()
    fg[:6] = True  # 6 foreground ROIs on rank 0, fewer on rank 1
    fg[6:9] = False
    logits = np.random.RandomState(5).randn(len(masks), 28, 28, 6).astype(np.float32) * 2
    mask_want, mask_grad = jax.value_and_grad(
        lambda lg: jmask.mask_rcnn_loss(lg, *map(jnp.asarray, (classes, masks, gt, roi, fg))))(
        jnp.asarray(logits))
    jh = JHead(num_classes=NUM_CLASSES, depth=26, res2_out_channels=64, mode="mean")
    feats, sboxes, svalid = support_inputs()
    pooled, qgt, qvalid = query_inputs()  # its last 3 query slots are invalid: rank 1's
    key, base = jax.random.PRNGKey(0), np.asarray(VA_BASE)
    v1 = jh.init(key, feats, sboxes, svalid, base, method=JHead.support_prototypes)
    att = jh.apply(v1, feats, sboxes, svalid, base, method=JHead.support_prototypes)
    v2 = jh.init(key, pooled, qgt, qvalid, att, base, method=JHead.rank_loss)
    params = randomize_params({**v2["params"], **v1["params"]}, seed=5)

    def rank_loss(p):
        a = jh.apply({"params": p}, feats, sboxes, svalid, base,
                     method=JHead.support_prototypes)
        out = jh.apply({"params": p}, pooled, qgt, qvalid, a, base, method=JHead.rank_loss)
        return sum(out.values()), out

    (_, rank_want), rank_grad = jax.value_and_grad(rank_loss, has_aux=True)(params)
    rank_grad = flatten_tree(jax.tree.map(np.asarray, rank_grad))
    got = spawn(tmp_path_factory.mktemp("rdzv"), rank_losses,
                dict(scores=scores, deltas=deltas, fields=fields, classes=C),
                dict(logits=logits, classes=classes, masks=masks, gt=gt, roi=roi, fg=fg),
                dict(num_classes=NUM_CLASSES, base=VA_BASE, feats=feats, boxes=sboxes,
                     valid=svalid, pooled=pooled, gt=qgt, qvalid=qvalid,
                     params=flatten_tree(jax.tree.map(np.asarray, params))))
    return {"frcnn": (fr_want, (fr_grads[0], fr_grads[1])), "mask": (mask_want, (mask_grad,)),
            "rank": (rank_want, (rank_grad,))}, got


def ranks_mean(values):
    return {k: float(np.mean([v[k] for v in values])) for k in values[0]}


@pytest.mark.parametrize("name", ["frcnn", "mask", "rank"])
def test_batch_spanning_loss_at_world_two_is_the_whole_batchs(losses, name):
    want, got = losses
    want_losses, want_grads = want[name]
    per_rank = [g[name] for g in got]
    if name == "mask":
        assert abs(np.mean([loss for loss, _ in per_rank]) - float(want_losses)) <= 1e-5
    else:
        mean = ranks_mean([loss for loss, *_ in per_rank])
        assert set(mean) == set(want_losses)
        for k, v in want_losses.items():
            np.testing.assert_allclose(mean[k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    if name == "rank":  # the head's parameters: the ranks' mean, as the step takes it
        (want_grad,) = want_grads
        grads = [g[1] for g in per_rank]
        assert set(grads[0]) <= set(want_grad)
        for path in grads[0]:
            grad = (grads[0][path] + grads[1][path]) / 2
            np.testing.assert_allclose(grad, want_grad[path], rtol=1e-4,
                                       atol=1e-5 * np.abs(want_grad[path]).max() + 1e-12,
                                       err_msg=path)
        return
    # each rank's gradient on its own inputs, averaged over the 2 ranks as the
    # step averages it, is the whole batch's gradient on those inputs
    for i, want_grad in enumerate(want_grads):
        grad = np.concatenate([g[1 + i] for g in per_rank]) / 2
        want_grad = np.asarray(want_grad)
        np.testing.assert_allclose(grad, want_grad, rtol=1e-4,
                                   atol=1e-5 * np.abs(want_grad).max(), err_msg=name)


# ------------------------------------------------------------------ loaders
def records(n, seed=0, portrait_share=0.4):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = (120, 90) if rng.rand() < portrait_share else (90, 120)
        out.append({"image_id": f"im{i}", "file_name": f"/nonexistent/im{i}.png",
                    "height": h, "width": w,
                    "annotations": [{"bbox": [5.0, 5.0, 40.0, 40.0], "category_id": 1}]})
    return out


def recording_loader(seen):
    def load(rec):
        seen.append(rec["image_id"])
        rng = np.random.RandomState(zlib.crc32(rec["image_id"].encode()) % 2**31)
        return rng.rand(rec["height"], rec["width"], 3).astype(np.float32) * 255
    return load


def stream(mod, shard, frac, canvas=(64, 96), skip=0, n=12):
    """(batches, record ids loaded) of a loader of module ``mod``."""
    seen = []
    loader = mod.StreamLoader(shard, mod.TransformConfig(
        min_sizes=(64,), max_size=96, canvas=canvas, flip=True, max_gt=5, num_classes=20),
        batch_size=2, keys=mod._STRONG_KEYS, seed=3, image_loader=recording_loader(seen),
        sync_portrait_frac=frac)
    loader.fast_forward(skip)
    it = iter(loader)
    return [next(it) for _ in range(n)], seen


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shard", [0, 1])
def test_synced_stream_loader_matches_unit_tpu(shard):
    full = records(40)
    frac = sum(r["height"] > r["width"] for r in full) / len(full)
    mine = full[shard::2]
    got, got_ids = stream(tloader, mine, frac)
    want, want_ids = stream(jloader, mine, frac)
    assert_same_batches(got, want)
    assert got_ids == want_ids and len(got_ids) == 24
    assert len({b["image"].shape[1:3] for b in got}) == 2  # both orientations scheduled
    # the other shard follows the same orientation schedule
    other, _ = stream(tloader, full[1 - shard::2], frac)
    assert [b["image"].shape for b in other] == [b["image"].shape for b in got]
    # resume: fast_forward(5), then batches 6-12 (and unit_tpu's alike)
    resumed, _ = stream(tloader, mine, frac, skip=5, n=7)
    assert_same_batches(resumed, got[5:])
    assert_same_batches(resumed, stream(jloader, mine, frac, skip=5, n=7)[0])


@pytest.mark.parametrize("mod", [tloader, jloader], ids=["port", "unit_tpu"])
def test_synced_stream_loader_refuses_a_shard_without_an_orientation(mod):
    landscape = [r for r in records(40) if r["height"] <= r["width"]]
    with pytest.raises(RuntimeError, match="portrait"):
        stream(mod, landscape, 0.5, n=20)
    loader = mod.StreamLoader(landscape, mod.TransformConfig(
        min_sizes=(64,), max_size=96, canvas=(64, 96), max_gt=5), batch_size=2,
        keys=mod._STRONG_KEYS, seed=3, image_loader=recording_loader([]),
        sync_portrait_frac=0.5)
    with pytest.raises(RuntimeError, match="orientation schedule"):
        loader.fast_forward(20)


def test_synced_stream_loader_on_a_square_canvas_buckets_plainly():
    full = records(12)
    got, ids = stream(tloader, full, 0.4, canvas=(96, 96), n=4)
    want, want_ids = stream(jloader, full, 0.4, canvas=(96, 96), n=4)
    assert all(b["image"].shape[1:3] == (96, 96) for b in got)
    assert_same_batches(got, want)
    assert ids == want_ids
    assert_same_batches(stream(tloader, full, 0.4, canvas=(96, 96), skip=2, n=2)[0], got[2:])


@pytest.fixture(scope="module")
def split_loaders(tmp_path_factory):
    from tests.test_torch_data import write_devkit

    devkit = write_devkit(tmp_path_factory.mktemp("VOCdevkit"), sizes=DEVKIT_SIZES)
    return devkit, spawn(tmp_path_factory.mktemp("rdzv"), rank_loaders, devkit, LOADER_OPTS)


@pytest.mark.parametrize("rank", [0, 1])
def test_every_split_loader_at_world_two_matches_unit_tpus_process(split_loaders, rank,
                                                                   monkeypatch):
    """The port's rank r against unit_tpu as process r of 2 (its
    ``_host_shard``, ``_sync_portrait_frac`` and ``_per_host_batch`` read
    jax.process_index and jax.process_count)."""
    devkit, ranks = split_loaders
    got = ranks[rank]
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    cfg = jget_cfg()
    cfg.merge_from_list(LOADER_OPTS + ["DATASETS.CLASSIFIER_DATAROOT", devkit])
    jdata.DatasetCatalog.clear()
    jdata.RegisterVOC(cfg, devkit).register_all()
    for name, build in (("strong", jdata.build_strong_loader),
                        ("classifier", jdata.build_classifier_loader),
                        ("classifier_strong", jloader.build_classifier_strong_loader)):
        loader = build(cfg, seed=3, image_loader=seeded_image_loader)
        it = iter(loader)
        batch_size, frac, batches, resumed = got[name]
        assert (batch_size, frac) == (loader.batch_size, loader.sync_portrait_frac), name
        assert batch_size == 2 and frac is not None
        assert_same_batches(batches, [next(it) for _ in range(STREAM_BATCHES)])
        assert_same_batches(resumed, batches[2:4])
    for name, build in (("test", jdata.build_test_loader),
                        ("tta", jloader.build_tta_test_loader)):
        loader, n = build(cfg, "voc_base_training_query_val", image_loader=seeded_image_loader)
        want = (n, [b["image_id"] for b in loader])
        assert got[name] == want and n == 4, name
    other = ranks[1 - rank]
    assert not set(sum(got["test"][1], [])) & set(sum(other["test"][1], []))


# ------------------------------------------------------------------ evaluation
def test_gathered_evaluation_equals_one_pass_and_unit_tpus(tmp_path):
    ids = [f"i{k}" for k in range(7)]
    classes = ["a", "b"]
    a, b = spawn(tmp_path, rank_evaluate, ids, classes)
    assert a == b  # every rank scores the whole set
    voc, coco = PascalVOCEvaluator(classes, use_07_metric=False), COCOEvaluator(classes)
    jvoc, jcoco = JVOCEvaluator(classes, use_07_metric=False), JCOCOEvaluator(classes)
    for ev in (voc, jvoc):
        voc_feed(ev, ids)
    for ev in (coco, jcoco):
        coco_feed(ev, ids)
    assert a[0] == voc.evaluate() == jvoc.evaluate()
    assert a[1] == coco.evaluate() == jcoco.evaluate()
    assert 0 < a[0]["bbox"]["AP50"] < 100 and 0 < a[1]["bbox"]["AP"] < 100
