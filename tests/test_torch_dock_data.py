"""The dock recipe's data path: unit_tpu_torch vs unit_tpu on a shapes-COCO devkit.

scripts/make_shapes_coco_torch.py writes a small COCO-layout devkit (the
dock suite reads its 2014 splits, linked here to the 2017 ones) and
scripts/make_shapes_proposals_torch.py MCG-style proposal pickles for it
(the same files as scripts/make_shapes_proposals.py).  On it the two
packages must agree exactly, since both are the same numpy code drawing from
the same seeded RandomState in the same order: the proposal file layouts,
the padding, scaling, clipping and flipping of a record's proposals, and the
``proposals`` / ``proposals_valid`` fields of the four loaders (strong,
classifier, test and TTA) batch for batch, with and without the files
(R12: the classifier loader pads invalid slots when it has none).
"""

import os
import pickle
import runpy

import numpy as np
import pytest

import unit_tpu.data as jdata
import unit_tpu.data.coco as jcoco
import unit_tpu.data.loader as jloader
import unit_tpu_torch.data as tdata
from tests.test_torch_data import seeded_image_loader
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.data import proposals as jprops
from unit_tpu.data.transforms import TransformConfig as JTransformConfig
from unit_tpu.data.transforms import prepare_detection_record as jprepare
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data import proposals as tprops
from unit_tpu_torch.data.transforms import TransformConfig, prepare_detection_record
from unit_tpu_torch.data.utils import register_datasets

DOCK = "configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"
SHAPES = runpy.run_path("scripts/make_shapes_coco_torch.py")
PROPOSALS = runpy.run_path("scripts/make_shapes_proposals_torch.py")


def link_2014(root):
    """The dock suite's val2014 as the devkit's val2017 (train2014 is linked
    by the devkit writer)."""
    for src, dst in (("val2017", "val2014"),
                     (os.path.join("annotations", "instances_val2017.json"),
                      os.path.join("annotations", "instances_val2014.json"))):
        if not os.path.exists(os.path.join(root, dst)):
            os.symlink(os.path.basename(src), os.path.join(root, dst))


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes_coco_dock"))
    SHAPES["write_shapes_coco"](root, train_images=16, val_images=4, size=96, seed=5)
    link_2014(root)
    PROPOSALS["write_proposals"](root, ("train2014", "val2014"), per_image=30, seed=11)
    return root


def test_the_twin_script_writes_the_same_proposals(devkit, tmp_path, monkeypatch):
    os.symlink(os.path.join(devkit, "annotations"), tmp_path / "annotations")
    monkeypatch.setattr("sys.argv", ["make_shapes_proposals.py", "--root", str(tmp_path),
                                     "--per-image", "30", "--seed", "11"])
    runpy.run_path("scripts/make_shapes_proposals.py", run_name="__main__")
    for split in ("train2014", "val2014"):
        with open(os.path.join(devkit, f"proposals_{split}.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / f"proposals_{split}.pkl", "rb") as f:
            want = pickle.load(f)
        assert set(got) == set(want) and len(got) >= 4
        for k in want:
            for field in ("boxes", "scores"):
                np.testing.assert_array_equal(got[k][field], want[k][field])
                assert got[k][field].dtype == np.float32


def test_proposal_file_layouts(tmp_path):
    rng = np.random.RandomState(0)
    table = {str(i): {"boxes": rng.rand(5, 4).astype(np.float32) * 50,
                      "scores": rng.rand(5).astype(np.float32)} for i in range(3)}
    paths = {"pkl": tmp_path / "p.pkl", "npz": tmp_path / "p.npz",
             "ids": tmp_path / "ids.pkl"}
    with open(paths["pkl"], "wb") as f:
        pickle.dump(table, f)
    np.savez(paths["npz"], proposals=np.asarray(table, dtype=object))
    with open(paths["ids"], "wb") as f:
        pickle.dump({"ids": [int(k) for k in table],
                     "boxes": [v["boxes"] for v in table.values()],
                     "objectness_logits": [v["scores"] for v in table.values()]}, f)
    for path in paths.values():
        got, want = tprops.load_proposal_file(str(path)), jprops.load_proposal_file(str(path))
        assert set(got) == set(want) == set(table)
        for k in table:
            for field in ("boxes", "scores"):
                np.testing.assert_array_equal(got[k][field], want[k][field])
                np.testing.assert_array_equal(got[k][field], table[k][field])


@pytest.mark.parametrize("flip", [False, True])
def test_a_records_proposals_are_the_same(flip):
    """Top-K by score, scaled with the image, clipped to it (empty ones
    invalid), mirrored with a flip, padded."""
    rng = np.random.RandomState(int(flip))
    boxes = np.concatenate([rng.uniform(-20, 140, (12, 2)), rng.uniform(0, 60, (12, 2))], 1)
    boxes[:, 2:] += boxes[:, :2]
    boxes[3] = [200, 10, 220, 30]  # outside: empty after the clip
    rec = {"image_id": "7", "height": 90, "width": 120, "proposals": boxes.astype(np.float32),
           "annotations": [{"bbox": [10, 10, 50, 40], "category_id": 3}]}
    recs = [dict(rec), dict(rec)]
    tprops.attach_proposals(recs[:1], (), 8)  # no files: nothing changes
    assert recs[0]["proposals"] is rec["proposals"]
    image = seeded_image_loader(rec)
    kw = dict(min_sizes=(64,), max_size=128, canvas=(64, 96), flip=True, max_gt=4,
              num_classes=80, proposal_capacity=10)
    aug = (64, flip)
    got = prepare_detection_record(recs[0], TransformConfig(**kw), None, image=image, aug=aug)
    want = jprepare(recs[1], JTransformConfig(**kw), np.random.RandomState(0), image=image,
                    aug=aug)
    for k in ("proposals", "proposals_valid", "image", "gt_boxes"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pb, pv = got["proposals"], got["proposals_valid"]
    assert pb.shape == (10, 4) and not pv[3] and pv.any()
    np.testing.assert_array_equal(pv, (pb[:, 2] > pb[:, 0]) & (pb[:, 3] > pb[:, 1]))
    h, w = got["image_size"]
    assert pb[:, 0::2].max() <= w and pb[:, 1::2].max() <= h and pb.min() >= 0


def test_attach_reads_the_files_top_k(devkit):
    path = os.path.join(devkit, "proposals_val2014.pkl")
    table = tprops.load_proposal_file(path)
    recs_t = [{"image_id": k} for k in table] + [{"image_id": "absent"}]
    recs_j = [dict(r) for r in recs_t]
    tprops.attach_proposals(recs_t, [path, os.path.join(devkit, "missing.pkl")], 12)
    jprops.attach_proposals(recs_j, [path], 12)
    assert "proposals" not in recs_t[-1]
    for a, b in zip(recs_t[:-1], recs_j[:-1]):
        np.testing.assert_array_equal(a["proposals"], b["proposals"])
        np.testing.assert_array_equal(a["proposal_scores"], b["proposal_scores"])
        assert a["proposals"].shape == (12, 4)


def dock_cfgs(devkit, files=True, *opts):
    cfgs = []
    for get in (get_cfg, jget_cfg):
        cfg = get()
        cfg.merge_from_file(DOCK)
        cfg.merge_from_list(["DATASETS.CLASSIFIER_DATAROOT", devkit, "SOLVER.IMS_PER_BATCH", "2",
                             "INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN", "128",
                             "INPUT.MIN_SIZE_TEST", "80", "INPUT.MAX_SIZE_TEST", "128",
                             "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", "40",
                             "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "20",
                             "TEST.AUG.MIN_SIZES", "(64, 96)", "TEST.AUG.MAX_SIZE", "160",
                             "TPU.MAX_GT_BOXES", "6", *opts])
        if files:
            cfg.DATASETS.PROPOSAL_FILES_TRAIN = (os.path.join(devkit, "proposals_train2014.pkl"),)
            cfg.DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN = cfg.DATASETS.PROPOSAL_FILES_TRAIN
            cfg.DATASETS.PROPOSAL_FILES_TEST = (os.path.join(devkit, "proposals_val2014.pkl"),)
        cfgs.append(cfg)
    return cfgs


def registered(devkit, files=True, *opts):
    tcfg, jcfg = dock_cfgs(devkit, files, *opts)
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    register_datasets(tcfg, devkit)
    jcoco.RegisterCOCODock(jcfg, devkit).register_all()
    return tcfg, jcfg


def assert_same_batches(tit, jit, n, keys=None):
    for _ in range(n):
        got, want = next(tit), next(jit)
        assert set(got) == set(want)
        for k in keys or want:
            if k == "variants":
                for gv, wv in zip(got[k], want[k]):
                    for kk in ("image", "image_size", "flip"):
                        np.testing.assert_array_equal(gv[kk], wv[kk], err_msg=kk)
                continue
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    return got


@pytest.mark.parametrize("files", [True, False], ids=["files", "yaml_alone"])
def test_the_strong_stream_carries_the_same_proposals(devkit, files):
    tcfg, jcfg = registered(devkit, files)
    got = assert_same_batches(
        iter(tdata.build_strong_loader(tcfg, seed=3, image_loader=seeded_image_loader)),
        iter(jdata.build_strong_loader(jcfg, seed=3, image_loader=seeded_image_loader)), 3)
    if files:
        assert got["proposals"].shape == (2, 40, 4) and got["proposals_valid"].any()
    else:  # no PROPOSAL_FILES_TRAIN: the strong stream falls back to the RPN
        assert "proposals" not in got


def test_the_classifier_stream_carries_the_same_proposals(devkit):
    tcfg, jcfg = registered(devkit)
    got = assert_same_batches(
        iter(tdata.build_classifier_loader(tcfg, seed=4, image_loader=seeded_image_loader)),
        iter(jdata.build_classifier_loader(jcfg, seed=4, image_loader=seeded_image_loader)), 3)
    assert got["proposals"].shape == (2, 40, 4) and got["proposals_valid"].sum() > 40


def test_classifier_loader_pads_invalid_proposals_without_files_as_unit_tpu_does(devkit):
    """R12: under MODEL.LOAD_PROPOSALS, with no file in
    DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN (the shipped YAML), unit_tpu's
    classifier loader still pads PRECOMPUTED_PROPOSAL_TOPK_TRAIN slots, all
    invalid, and train_losses takes them (``"proposals" in weak``): the weak
    stream trains on no valid proposal.  The port keeps this for parity."""
    tcfg, jcfg = registered(devkit, False)
    assert not tcfg.DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN and tcfg.MODEL.LOAD_PROPOSALS
    got = assert_same_batches(
        iter(tdata.build_classifier_loader(tcfg, seed=4, image_loader=seeded_image_loader)),
        iter(jdata.build_classifier_loader(jcfg, seed=4, image_loader=seeded_image_loader)), 2)
    assert got["proposals"].shape == (2, 40, 4) and not got["proposals_valid"].any()
    # zero boxes; a flipped image mirrors them to x = its width, in both
    assert (got["proposals"][..., 1::2] == 0).all()
    assert (got["proposals"][..., 0] == got["proposals"][..., 2]).all()


@pytest.mark.parametrize("batch_size", [1, 3])
def test_the_test_loader_carries_the_same_proposals(devkit, batch_size):
    tcfg, jcfg = registered(devkit)
    name = tcfg.DATASETS.TEST[0]
    tl, tn = tdata.build_test_loader(tcfg, name, image_loader=seeded_image_loader,
                                     batch_size=batch_size)
    jl, jn = jdata.build_test_loader(jcfg, name, image_loader=seeded_image_loader,
                                     batch_size=batch_size)
    try:
        assert tn == jn == 4
        got = assert_same_batches(tl, jl, 4 // batch_size,
                                  ("image", "image_size", "proposals", "proposals_valid",
                                   "scale", "orig_size"))
        assert got["proposals"].shape == (batch_size, 20, 4)
        assert got["proposals_valid"].all()
    finally:
        tl.close()
        jl.close()


def test_the_tta_loader_carries_the_canonical_proposals(devkit):
    tcfg, jcfg = registered(devkit, True, "TEST.AUG.ENABLED", "True")
    name = tcfg.DATASETS.TEST[0]
    tl, _ = tdata.build_tta_test_loader(tcfg, name, image_loader=seeded_image_loader)
    jl, _ = jloader.build_tta_test_loader(jcfg, name, image_loader=seeded_image_loader)
    try:
        got = assert_same_batches(tl, jl, 4, ("image", "image_size", "proposals",
                                              "proposals_valid", "variants"))
        assert got["proposals"].shape == (1, 20, 4) and len(got["variants"]) == 4
        # the canonical frame: the proposals fit the canonical content
        h, w = got["image_size"][0]
        assert got["proposals"][0, :, 2].max() <= w and got["proposals"][0, :, 3].max() <= h
    finally:
        tl.close()
        jl.close()
