"""The COCO data side of unit_tpu_torch vs unit_tpu on a shapes-COCO devkit.

scripts/make_shapes_coco_torch.py writes a small COCO-layout devkit (JPEG
files, instances JSON with real polygons) into a temporary directory; it
must write the same files as scripts/make_shapes_coco.py.  On it the two
packages must agree exactly: the polygon masks (GT-box-frame bitmasks and
image-frame rasters) bit for bit, the records of load_coco_json and of every
dataset RegisterCOCO registers (the seeded k-shot sample included), the
gt_masks of prepare_detection_record, flipped and not, and the batches of
the strong stream under MODEL.MASK_ON.  Both sides are the same numpy code
and draw from the same seeded RandomState in the same order.
"""

import filecmp
import json
import os
import runpy

import numpy as np
import pytest

import unit_tpu.data as jdata
import unit_tpu.data.coco as jcoco
import unit_tpu_torch.data as tdata
import unit_tpu_torch.data.coco as tcoco
from tests.test_torch_data import seeded_image_loader
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu.data.transforms import TransformConfig as JTransformConfig
from unit_tpu.data.transforms import prepare_detection_record as jprepare
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.data.transforms import TransformConfig, prepare_detection_record
from unit_tpu_torch.data.utils import register_datasets

SEGM = "configs/COCO/COCO-RCNN-50-C4-split1-segm.yaml"
SHAPES = runpy.run_path("scripts/make_shapes_coco_torch.py")


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes_coco"))
    SHAPES["write_shapes_coco"](root, train_images=24, val_images=6, size=96, seed=5)
    return root


def test_the_twin_script_writes_the_same_devkit(devkit, tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", ["make_shapes_coco.py", "--root", str(tmp_path),
                                     "--train-images", "24", "--val-images", "6",
                                     "--size", "96", "--seed", "5"])
    runpy.run_path("scripts/make_shapes_coco.py", run_name="__main__")
    for split in ("train2017", "val2017", "train2014"):
        with open(os.path.join(devkit, "annotations", f"instances_{split}.json")) as f:
            got = json.load(f)
        with open(tmp_path / "annotations" / f"instances_{split}.json") as f:
            assert got == json.load(f), split
        names = sorted(os.listdir(os.path.join(devkit, split)))
        assert names == sorted(os.listdir(tmp_path / split)) and len(names) >= 6
        match, mismatch, errors = filecmp.cmpfiles(os.path.join(devkit, split),
                                                   tmp_path / split, names, shallow=False)
        assert not mismatch and not errors, (split, mismatch, errors)


def annotations(devkit, split="train2017"):
    with open(os.path.join(devkit, "annotations", f"instances_{split}.json")) as f:
        data = json.load(f)
    return data["annotations"], {im["id"]: im for im in data["images"]}


def odd_polygons():
    """Polygons off the shapes generator: outside the image, a sliver, a
    self-crossing bow tie, a shared vertex."""
    return [
        [[-10.0, -5.0, 30.0, -5.0, 30.0, 20.0, -10.0, 20.0]],
        [[5.0, 5.0, 60.0, 5.5, 5.0, 6.0]],
        [[10.0, 10.0, 50.0, 40.0, 50.0, 10.0, 10.0, 40.0]],
        [[20.0, 20.0, 40.0, 20.0, 30.0, 30.0], [30.0, 30.0, 45.0, 45.0, 20.0, 45.0]],
        [[0.0, 0.0, 95.5, 0.0, 95.5, 95.5, 0.0, 95.5]],
    ]


@pytest.mark.parametrize("size", [14, 28])
def test_box_masks_are_bit_identical(devkit, size):
    anns, _ = annotations(devkit)
    polys = [a["segmentation"] for a in anns] + odd_polygons()
    boxes = [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
              a["bbox"][1] + a["bbox"][3]] for a in anns] + [
        [-10, -5, 30, 20], [5, 5, 60, 6], [10, 10, 50, 40], [20, 20, 45, 45], [0, 0, 95.5, 95.5]]
    for poly, box in zip(polys, boxes):
        got = tcoco.polygons_to_boxmask(poly, box, size)
        want = jcoco.polygons_to_boxmask(poly, box, size)
        assert got.dtype == want.dtype and got.shape == (size, size)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(96, 96), (50, 70)])
def test_image_rasters_are_bit_identical(devkit, shape):
    anns, _ = annotations(devkit)
    hits = 0
    for poly in [a["segmentation"] for a in anns] + odd_polygons():
        got = tcoco.rasterize_polygons(poly, *shape)
        want = jcoco.rasterize_polygons(poly, *shape)
        assert got.dtype == want.dtype and got.shape == shape
        np.testing.assert_array_equal(got, want)
        hits += int(got.any())
    assert hits > 10


def assert_same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k != "annotations":
                assert g[k] == w[k], k
        assert len(g["annotations"]) == len(w["annotations"])
        for ga, wa in zip(g["annotations"], w["annotations"]):
            assert set(ga) == set(wa)
            for k in wa:
                if isinstance(wa[k], np.ndarray):
                    assert ga[k].dtype == wa[k].dtype
                    np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
                else:
                    assert ga[k] == wa[k], k


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("classes", [None, (0, 2, 7, 15, 40, 79)])
def test_load_coco_json_gives_the_same_records(devkit, with_masks, classes):
    ann = os.path.join(devkit, "annotations", "instances_train2017.json")
    img = os.path.join(devkit, "train2017")
    got = tcoco.load_coco_json(ann, img, classes, with_masks)
    want = jcoco.load_coco_json(ann, img, classes, with_masks)
    assert_same_records(got, want)
    assert with_masks == any("box_mask" in a for r in got for a in r["annotations"])


def coco_cfgs(devkit, *opts):
    cfgs = []
    for get in (get_cfg, jget_cfg):
        cfg = get()
        cfg.merge_from_file(SEGM)
        cfg.merge_from_list(["DATASETS.CLASSIFIER_DATAROOT", devkit, "SOLVER.IMS_PER_BATCH", "2",
                             "INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN", "128",
                             "INPUT.MIN_SIZE_TEST", "80", "INPUT.MAX_SIZE_TEST", "128",
                             "TPU.MAX_GT_BOXES", "6", *opts])
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("suite,cls", [("COCO", "RegisterCOCO"), ("COCO_NOTE", "RegisterCOCONote"),
                                       ("COCO_DOCK", "RegisterCOCODock")])
@pytest.mark.parametrize("shots", [1, 3])
def test_registration_and_the_kshot_sample_are_the_same(devkit, suite, cls, shots):
    tcfg, jcfg = coco_cfgs(devkit, "DATASETS.FEWSHOT.TYPE", suite,
                           "DATASETS.FEWSHOT.NUM_SHOTS", str(shots))
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    register_datasets(tcfg, devkit)
    getattr(jcoco, cls)(jcfg, devkit).register_all()
    names = sorted(jdata.DatasetCatalog.list())
    assert sorted(tdata.DatasetCatalog.list()) == names and len(names) == 7
    for name in names:
        if name.endswith("_support"):
            continue
        assert vars(tdata.MetadataCatalog.get(name)) == vars(jdata.MetadataCatalog.get(name))
        if suite == "COCO_DOCK" and "2017" not in name:
            continue  # the dock suite reads COCO2014's val split, which the devkit lacks
        assert_same_records(tdata.DatasetCatalog.get(name), jdata.DatasetCatalog.get(name))
    if suite != "COCO_DOCK":
        # the k-shot sample: a non-empty subset of the train split's images
        prefix = getattr(tcoco, cls).prefix
        ft = {r["image_id"] for r in tdata.DatasetCatalog.get(f"{prefix}_fine_tuning_query_train")}
        everything = {r["image_id"] for r in tdata.DatasetCatalog.get("coco_train_2017")}
        assert ft and ft <= everything and (shots > 1 or ft != everything)


@pytest.mark.parametrize("flip", [False, True])
def test_gt_masks_of_a_record_are_the_same(devkit, flip):
    tcfg, jcfg = coco_cfgs(devkit)
    ann = os.path.join(devkit, "annotations", "instances_train2017.json")
    recs = tcoco.load_coco_json(ann, os.path.join(devkit, "train2017"), None, True)
    tt, jt = TransformConfig.train_from_cfg(tcfg), JTransformConfig.train_from_cfg(jcfg)
    assert tt.with_masks and tt.mask_size == jt.mask_size == 28
    for rec in recs[:6]:
        image = seeded_image_loader(rec)
        got = prepare_detection_record(rec, tt, None, image=image, aug=(80, flip))
        want = jprepare(rec, jt, None, image=image, aug=(80, flip))
        assert set(got) == set(want) and "gt_masks" in got
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        n = len(rec["annotations"])
        assert got["gt_masks"][:n].any() and not got["gt_masks"][n:].any()
        first = rec["annotations"][0]["box_mask"]
        np.testing.assert_array_equal(got["gt_masks"][0], first[:, ::-1] if flip else first)


def test_strong_stream_carries_the_same_gt_masks(devkit):
    tcfg, jcfg = coco_cfgs(devkit)
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    register_datasets(tcfg, devkit)
    jcoco.RegisterCOCO(jcfg, devkit).register_all()
    tit = iter(tdata.build_strong_loader(tcfg, seed=3, image_loader=seeded_image_loader))
    jit = iter(jdata.build_strong_loader(jcfg, seed=3, image_loader=seeded_image_loader))
    for _ in range(4):
        got, want = next(tit), next(jit)
        assert set(got) == set(want) and got["gt_masks"].shape == (2, 6, 28, 28)
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=k)
