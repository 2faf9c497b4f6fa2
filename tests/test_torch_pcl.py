"""PCL (ops/kmeans.py, models/pcl.py): unit_tpu_torch vs unit_tpu.

Every comparison feeds the same seeded numpy inputs to both packages
(unit_tpu's functions run eagerly on the CPU; none reaches a Pallas kernel).

Bounds, each with its reason:
  * k-means where the optimum is unique by a wide margin (values drawn as
    three well-separated groups, invalid entries and fewer than k valid
    values included): assignments and top-cluster masks identical, centers
    within 1e-6 (the same f32 prefix sums, summed in another order);
  * k-means on uniform values, where partitions within f32 rounding of each
    other can exist (the interval costs ``c2 - cs^2 / cw`` cancel, and XLA
    and PyTorch order their cumulative sums differently): the objective
    (inertia, in f64 from the returned assignments) within 1e-5 relative;
    where the assignments agree, the top-cluster masks agree too;
  * graph centers, clusters and PCL targets: identical (integer decisions of
    the same f32 comparisons; cluster scores are copied probabilities);
  * the PCL loss and every loss of ``pcl_detector_losses``: rtol 1e-5, and
    gradients within 1e-5 of the largest |gradient| plus 1e-7 (the f32 sums
    of two libraries; measured agreement ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unit_tpu.models import pcl as jpcl
from unit_tpu.models.weak_losses import WeakLossConfig as JCfg
from unit_tpu.ops import kmeans as jkm
from unit_tpu_torch.models import pcl as tpcl
from unit_tpu_torch.models.weak_losses import WeakLossConfig as TCfg
from unit_tpu_torch.ops import kmeans as tkm

RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-5, 1e-7
C = 20


def t(x):
    return torch.as_tensor(np.array(x))


def boxes(rng, n, h=160.0, w=224.0, lo=8.0, hi=120.0):
    xy = rng.uniform(0, 1, (n, 2)) * [w - lo, h - lo]
    wh = rng.uniform(lo, hi, (n, 2))
    b = np.concatenate([xy, xy + wh], 1)
    b[:, 0::2] = b[:, 0::2].clip(0, w)
    b[:, 1::2] = b[:, 1::2].clip(0, h)
    return b.astype(np.float32)


def kmeans_case(case, n, seed):
    rng = np.random.RandomState(seed)
    valid = rng.rand(n) > 0.2
    if case == "separated":
        values = rng.choice([0.05, 0.5, 0.95], n) + rng.uniform(-0.02, 0.02, n)
    else:
        values = rng.rand(n)
    if case == "few_valid":
        valid[:] = False
        valid[rng.choice(n, 2, replace=False)] = True
    values = np.where(valid, values, rng.rand(n) * 5)  # junk under invalid entries
    return values.astype(np.float32), valid


def inertia(values, valid, assign):
    v = values.astype(np.float64)
    return sum(((v[(assign == k) & valid] - v[(assign == k) & valid].mean()) ** 2).sum()
               for k in set(assign[valid].tolist()))


@pytest.mark.parametrize("n", [5, 64, 512])
@pytest.mark.parametrize("case", ["separated", "few_valid", "uniform"])
def test_kmeans_1d_and_top_cluster_mask(case, n):
    rows = [kmeans_case(case, n, seed) for seed in range(3)]
    values, valid = np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])
    got_a, got_c = tkm.kmeans_1d(t(values), t(valid))        # the rows in one batch
    got_m = tkm.top_cluster_mask(t(values), t(valid))
    for i, (v, m) in enumerate(rows):
        want_a, want_c = (np.asarray(x) for x in jkm.kmeans_1d(jnp.asarray(v), jnp.asarray(m)))
        want_m = np.asarray(jkm.top_cluster_mask(jnp.asarray(v), jnp.asarray(m)))
        one_a, _ = tkm.kmeans_1d(t(v), t(m))                   # one row alone
        np.testing.assert_array_equal(one_a.numpy(), got_a[i].numpy())
        a, c, mask = got_a[i].numpy(), got_c[i].numpy(), got_m[i].numpy()
        assert (a[~m] == -1).all() and mask.sum() >= 1 and not (mask & ~m).any()
        if case == "uniform":
            np.testing.assert_allclose(inertia(v, m, a), inertia(v, m, want_a), rtol=1e-5)
            if np.array_equal(a, want_a):
                np.testing.assert_array_equal(mask, want_m)
        else:
            np.testing.assert_array_equal(a, want_a)
            np.testing.assert_allclose(c, want_c, atol=1e-6)
            np.testing.assert_array_equal(mask, want_m)
        if case == "few_valid":  # the fallback: the largest valid value alone
            assert mask.sum() == 1 and v[mask][0] == v[m].max()


# ------------------------------------------------------------ graph centers
def clustered(rng, groups, per_group, spread=1.0):
    """``groups`` tight clusters of ``per_group`` near-identical boxes each,
    cluster 0 first (proposal 0 is its first box)."""
    centers = boxes(rng, groups, lo=20.0, hi=40.0)
    centers[:, 0::2] += np.arange(groups)[:, None] * 300.0  # far apart: no overlap
    out = [c + rng.uniform(-spread, spread, (per_group, 4)) for c in centers]
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("groups,per_group,expect", [
    (3, 4, "fewer"),   # 2 centers < max_pc_num: unit_tpu's used[0] is False
    (6, 3, "exact"),   # 5 centers = max_pc_num: used[0] is True
    (0, 0, "random"),
])
def test_extract_graph_centers(groups, per_group, expect):
    rng = np.random.RandomState(groups + 1)
    if expect == "random":
        bx = boxes(rng, 96)
        cand = rng.rand(96) > 0.3
    else:
        bx = clustered(rng, groups, per_group)
        cand = np.ones(len(bx), bool)
    probs = rng.rand(len(bx)).astype(np.float32)
    jb, js, jv, jused = (np.asarray(x) for x in jpcl._extract_graph_centers(
        jnp.asarray(bx), jnp.asarray(probs), jnp.asarray(cand), 0.4, 5, 32))
    over = tpcl.box_ops.pairwise_iou(t(bx), t(bx)) > 0.4
    idx, ts, tv, tused = tpcl._extract_graph_centers(over[None], t(probs)[None],
                                                     t(cand)[None], 5, 32)
    np.testing.assert_array_equal(bx[idx[0].numpy()], jb)
    np.testing.assert_array_equal(ts[0].numpy(), js)
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(tused[0].numpy(), jused)
    if expect != "random":
        assert bool((idx[0][tv[0]] == 0).any())  # proposal 0 is a center
        n_centers = int(tv[0].sum())
        assert (n_centers < 5) == (expect == "fewer")
        # unit_tpu's scatter leaves proposal 0 unclaimed when slots are padded
        assert bool(tused[0, 0]) == (expect == "exact")
        assert int(tused[0].sum()) == n_centers - (expect == "fewer")


@pytest.mark.parametrize("groups,per_group,spread_class_3", [(3, 4, False), (6, 3, True)])
def test_proposal_zero_carries_to_the_next_class(groups, per_group, spread_class_3):
    """Class 3, then class 11, both present, both with cluster 0 (proposal 0
    first) at the top.  Class 3 takes one center (the clusters of class 3's
    top scores: cluster 0 alone) or five (all clusters of the groups);
    with one, unit_tpu leaves proposal 0 unclaimed and class 11 picks it
    again; with five it is claimed and class 11 centers on proposal 1."""
    rng = np.random.RandomState(7)
    bx = clustered(rng, groups, per_group)
    background = boxes(rng, 36)
    background[:, 0::2] -= 1000.0  # away from the groups
    bx = np.concatenate([bx, background])
    n = groups * per_group
    scores = np.zeros((len(bx), C), np.float32)
    scores[n:] = np.where(np.arange(36)[:, None] < 18, 0.05, 0.4)  # two low levels
    top = slice(0, n) if spread_class_3 else slice(0, per_group)
    scores[top, 3] = 0.9 + rng.uniform(0, 1e-3, n if spread_class_3 else per_group)
    scores[:per_group, 11] = 0.9
    labels = np.zeros(C, np.float32)
    labels[[3, 11]] = 1.0
    valid = np.ones(len(bx), bool)
    want = jpcl.mine_pcl_clusters(jnp.asarray(scores), jnp.asarray(bx), jnp.asarray(valid),
                                  jnp.asarray(labels), JCfg(num_classes=C))
    got = tpcl.mine_pcl_clusters(t(scores)[None], t(bx)[None], t(valid)[None],
                                 t(labels)[None], TCfg(num_classes=C),
                                 tpcl.present_classes(t(labels)))
    for f in ("boxes", "classes", "scores", "valid"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    v = got.valid[0].reshape(C, 5)
    b = got.boxes[0].reshape(C, 5, 4)
    assert int(v[3].sum()) == (5 if spread_class_3 else 1) and int(v[11].sum()) == 1
    assert any(torch.equal(b[3, k], t(bx[0])) for k in range(int(v[3].sum())))
    assert torch.equal(b[11, 0], t(bx[1] if spread_class_3 else bx[0]))


# ------------------------------------------------------------ mining, targets
@pytest.mark.parametrize("n_present", [1, 2, 3])
def test_mine_pcl_clusters_and_targets(n_present):
    rng = np.random.RandomState(n_present)
    p, b = 512, 2
    bx = np.stack([boxes(rng, p) for _ in range(b)])
    valid = rng.rand(b, p) > 0.1
    scores = rng.dirichlet(np.ones(C + 1) * 0.3, (b, p)).astype(np.float32)
    labels = np.zeros((b, C), np.float32)
    for i in range(b):
        labels[i, rng.choice(C, n_present, replace=False)] = 1.0
    cfg_t, cfg_j = TCfg(num_classes=C), JCfg(num_classes=C)
    got = tpcl.mine_pcl_clusters(t(scores), t(bx), t(valid), t(labels), cfg_t,
                                 tpcl.present_classes(t(labels)))
    targets = tpcl.pcl_targets(got, t(bx), t(valid), cfg_t)
    for i in range(b):
        want = jpcl.mine_pcl_clusters(jnp.asarray(scores[i]), jnp.asarray(bx[i]),
                                      jnp.asarray(valid[i]), jnp.asarray(labels[i]), cfg_j)
        for f in ("boxes", "classes", "scores", "valid"):
            np.testing.assert_array_equal(getattr(got, f)[i].numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        assert int(want.valid.sum()) >= n_present
        want_t = jpcl.pcl_targets(want, jnp.asarray(bx[i]), jnp.asarray(valid[i]), cfg_j)
        for g, w in zip(targets, want_t):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert (targets[2] >= 0).any() and (targets[0] == C).any()  # fg and bg proposals


# ------------------------------------------------------------ losses
def assert_grad_close(got, want, what):
    bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
    assert np.abs(got - want).max() <= bound, (what, np.abs(got - want).max(), bound)


def test_pcl_loss_value_and_gradient():
    rng = np.random.RandomState(3)
    p = 64
    bx = boxes(rng, p)
    valid = rng.rand(p) > 0.1
    scores = rng.dirichlet(np.ones(C + 1), p).astype(np.float32)
    labels = np.zeros(C, np.float32)
    labels[[2, 9]] = 1.0
    logits = rng.randn(p, C + 1).astype(np.float32) * 2
    cfg_j = JCfg(num_classes=C)
    clusters = jpcl.mine_pcl_clusters(jnp.asarray(scores), jnp.asarray(bx), jnp.asarray(valid),
                                      jnp.asarray(labels), cfg_j)
    targets = jpcl.pcl_targets(clusters, jnp.asarray(bx), jnp.asarray(valid), cfg_j)

    def jloss(lg):
        return jpcl.pcl_loss(lg, clusters, *targets, jnp.asarray(valid), C)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    tc = tpcl.PCLClusters(*(t(np.asarray(x))[None] for x in clusters))
    tc = tc._replace(classes=tc.classes.long())
    lg = t(logits)[None].requires_grad_()
    got = tpcl.pcl_loss(lg, tc, *(t(np.asarray(x))[None].long() if x.dtype == jnp.int32
                                  else t(np.asarray(x))[None] for x in targets),
                        t(valid)[None], C)[0]
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    assert_grad_close(lg.grad[0].numpy(), np.asarray(want_g), "logits")
    assert float(got.detach()) > 0


def test_pcl_detector_losses_and_gradients():
    rng = np.random.RandomState(4)
    b, p, iters = 2, 96, 3
    bx = np.stack([boxes(rng, p) for _ in range(b)])
    valid = rng.rand(b, p) > 0.1
    labels = np.zeros((b, C), np.float32)
    labels[0, [1, 5, 17]] = 1.0
    labels[1, [5]] = 1.0
    streams = {"classifier_stream": rng.randn(b * p, C).astype(np.float32),
               "detection_stream": rng.randn(b * p, C).astype(np.float32) * 2,
               "oicr_scores": [rng.randn(b * p, C + 1).astype(np.float32) * 2
                               for _ in range(iters)]}
    kw = dict(weak_loss_multiplier=0.5, mil_multiplier=2.0, oicr_iter=iters)

    def jtotal(s):
        losses = jpcl.pcl_detector_losses(s, jnp.asarray(bx), jnp.asarray(valid),
                                          jnp.asarray(labels), JCfg(num_classes=C, **kw))
        return sum(losses.values()), losses

    (_, want), want_g = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jax.tree.map(jnp.asarray, streams))
    ts = {k: [t(x).requires_grad_() for x in v] if isinstance(v, list)
          else t(v).requires_grad_() for k, v in streams.items()}
    got = tpcl.pcl_detector_losses(ts, t(bx), t(valid), t(labels), TCfg(num_classes=C, **kw),
                                   tpcl.present_classes(t(labels)))
    assert set(got) == set(want) == {"loss_im_cls", "loss_oicr_1", "loss_oicr_2", "loss_oicr_3"}
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=RTOL, err_msg=k)
    torch.stack(list(got.values())).sum().backward()
    for k in ("classifier_stream", "detection_stream"):
        assert_grad_close(ts[k].grad.numpy(), np.asarray(want_g[k]), k)
    for i in range(iters):
        assert_grad_close(ts["oicr_scores"][i].grad.numpy(), np.asarray(want_g["oicr_scores"][i]),
                          f"oicr_scores[{i}]")
    assert float(got["loss_oicr_1"].detach()) > 0


def test_present_classes_reads_the_host_copy():
    labels = torch.zeros(3, C)
    labels[0, 4] = labels[2, 4] = labels[2, 19] = 1.0
    assert tpcl.present_classes(labels) == [4, 19]
    assert tpcl.present_classes(torch.zeros(2, C)) == []
