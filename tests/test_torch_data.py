"""The data side of unit_tpu_torch vs unit_tpu on a synthetic on-disk VOC devkit.

The devkit is built as tests/test_data.py builds its own (XML and image sets,
no image files; images come from a seeded ``image_loader``), with landscape
and portrait images so that both canvas orientations appear.  Registration,
the k-shot sampling, and the strong, classifier and test loaders must give
the same records and the same arrays, exactly: both sides are numpy and draw
from the same seeded ``RandomState`` in the same order.
"""

import zlib

import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu_torch.data as tdata
import unit_tpu_torch.data.loader as tloader
from unit_tpu.config import get_cfg as jget_cfg
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.models.similarity import VOC_CLASSES

_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>"""
_OBJ = """<object><name>{name}</name><difficult>{diff}</difficult>
  <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
</object>"""


def write_devkit(root, n_images=8, sizes=((100, 120), (120, 100)), seed=0):
    """A minimal VOCdevkit (2007 trainval/test, 2012 trainval) under ``root``;
    image i of a split has the (height, width) ``sizes[i % len(sizes)]``."""
    rng = np.random.RandomState(seed)
    for year, splits in [("2007", ["trainval", "test"]), ("2012", ["trainval"])]:
        base = root / f"VOC{year}"
        for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
            (base / sub).mkdir(parents=True)
        for split in splits:
            ids = []
            for i in range(n_images):
                h, w = sizes[i % len(sizes)]
                image_id = f"{year}_{split}_{i:03d}"
                ids.append(image_id)
                objs = []
                for _ in range(rng.randint(1, 4)):
                    cls = VOC_CLASSES[rng.randint(len(VOC_CLASSES))]
                    bw, bh = int(w * 0.3), int(h * 0.3)
                    x1, y1 = rng.randint(1, w - bw - 1), rng.randint(1, h - bh - 1)
                    objs.append(_OBJ.format(name=cls, diff=int(rng.rand() < 0.1), x1=x1, y1=y1,
                                            x2=x1 + bw, y2=y1 + bh))
                (base / "Annotations" / f"{image_id}.xml").write_text(
                    _XML.format(w=w, h=h, objects="\n".join(objs)))
            (base / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids))
    return str(root)


def seeded_image_loader(rec):
    """Float BGR content made from the record's id (the same in every process)."""
    rng = np.random.RandomState(zlib.crc32(rec["image_id"].encode()) % 2**31)
    return rng.rand(rec["height"], rec["width"], 3).astype(np.float32) * 255


def data_cfg(get, root):
    cfg = get()
    cfg.DATASETS.CLASSIFIER_DATAROOT = root
    cfg.DATASETS.TRAIN = ("voc_base_training_query_train",)
    cfg.DATASETS.TEST = ("voc_base_training_query_val",)
    cfg.DATASETS.CLASSIFIER_TRAIN = ("pascal_trainval_2007", "pascal_trainval_2012")
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.INPUT.MIN_SIZE_TRAIN = (96, 128)
    cfg.INPUT.MAX_SIZE_TRAIN = 160
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    return cfg


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return write_devkit(tmp_path_factory.mktemp("VOCdevkit"))


@pytest.fixture
def both(devkit):
    """(port cfg, unit_tpu cfg) with the devkit registered in both catalogs."""
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    tcfg, jcfg = data_cfg(get_cfg, devkit), data_cfg(jget_cfg, devkit)
    tdata.RegisterVOC(tcfg, devkit).register_all()
    jdata.RegisterVOC(jcfg, devkit).register_all()
    return tcfg, jcfg


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_registration_gives_the_same_records(both):
    names = sorted(jdata.DatasetCatalog.list())
    assert sorted(tdata.DatasetCatalog.list()) == names and len(names) >= 5
    for name in names:
        assert tdata.DatasetCatalog.get(name) == jdata.DatasetCatalog.get(name), name
        assert vars(tdata.MetadataCatalog.get(name)) == vars(jdata.MetadataCatalog.get(name))


@pytest.mark.parametrize("shots", [1, 3])
def test_kshot_registration_is_the_same(devkit, shots):
    tdata.DatasetCatalog.clear()
    jdata.DatasetCatalog.clear()
    tcfg, jcfg = data_cfg(get_cfg, devkit), data_cfg(jget_cfg, devkit)
    tcfg.DATASETS.FEWSHOT.NUM_SHOTS = jcfg.DATASETS.FEWSHOT.NUM_SHOTS = shots
    tdata.RegisterVOC(tcfg, devkit).register_all()
    jdata.RegisterVOC(jcfg, devkit).register_all()
    for name in ("voc_fine_tuning_query_train", "voc_fine_tuning_query_val"):
        got, want = tdata.DatasetCatalog.get(name), jdata.DatasetCatalog.get(name)
        assert got == want and len(got) > 0


@pytest.mark.parametrize("opts", [
    dict(WEAK_CLASSIFIER_SAMPLE_NUM=2, BASE_MULTIPLIER=1.0),
    dict(WEAK_CLASSIFIER_SAMPLE_NUM=2, BASE_MULTIPLIER=2.0, NOVEL_MULTIPLER=2),
    dict(WEAK_CLASSIFIER_SAMPLE_NUM=1, OVER_SAMPLE=True),
    dict(WEAK_CLASSIFIER_SAMPLE_NUM=1, OVER_SAMPLE=True, SAMPLE_WITH_REPLACEMENT=True),
    dict(WEAK_CLASSIFIER_SAMPLE_NUM=0),
])
def test_classifier_sampling_is_the_same(both, opts):
    tcfg, jcfg = both
    for k, v in opts.items():
        setattr(tcfg.DATASETS, k, v)
        setattr(jcfg.DATASETS, k, v)
    recs = jdata.DatasetCatalog.get("pascal_trainval_2007")
    got = tdata.sample_classifier_dataset(tcfg, tdata.DatasetCatalog.get("pascal_trainval_2007"))
    want = jdata.sample_classifier_dataset(jcfg, recs)
    assert got == want and len(got) > 0


@pytest.mark.parametrize("kind", ["strong", "classifier"])
def test_training_streams_are_the_same_and_fast_forward_is_exact(both, kind):
    tcfg, jcfg = both

    def build(mod, cfg):
        if kind == "strong":
            return mod.build_strong_loader(cfg, seed=3, image_loader=seeded_image_loader)
        return mod.build_classifier_loader(cfg, seed=4, image_loader=seeded_image_loader)

    tit, jit = iter(build(tdata, tcfg)), iter(build(jdata, jcfg))
    stream = []
    for _ in range(9):  # more than an epoch of the 8-image sets: a second permutation
        got, want = next(tit), next(jit)
        assert_same_batch(got, want)
        stream.append(got)
    shapes = {b["image"].shape[1:3] for b in stream}
    assert shapes == {(128, 160), (160, 128)}  # both orientations, homogeneous batches
    for n in (1, 4, 7):
        loader = build(tdata, tcfg)
        loader.fast_forward(n)
        it = iter(loader)
        for k in range(n, 9):
            assert_same_batch(next(it), stream[k])


@pytest.mark.parametrize("batch_size", [1, 3])
def test_test_loader_is_the_same(both, batch_size, tmp_path):
    tcfg, jcfg = both
    if batch_size > 1:
        # a test batch holds one canvas shape (as in unit_tpu): landscape only
        root = write_devkit(tmp_path / "landscape", sizes=((100, 120),))
        tdata.DatasetCatalog.clear()
        jdata.DatasetCatalog.clear()
        tdata.RegisterVOC(tcfg, root).register_all()
        jdata.RegisterVOC(jcfg, root).register_all()
    name = "voc_base_training_query_val"
    tl, tn = tdata.build_test_loader(tcfg, name, image_loader=seeded_image_loader,
                                     batch_size=batch_size)
    jl, jn = jdata.build_test_loader(jcfg, name, image_loader=seeded_image_loader,
                                     batch_size=batch_size)
    got, want = list(tl), list(jl)
    assert tn == jn == 8 and len(got) == len(want) == -(-8 // batch_size)
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        assert_same_batch({k: v for k, v in g.items() if k != "image_id"},
                          {k: v for k, v in w.items() if k != "image_id"})
    ids = [i for b in got for i in b["image_id"]]
    assert ids.count(None) == (-8 % batch_size) and len(set(ids) - {None}) == 8


def test_transform_configs_are_the_same(both):
    import dataclasses

    from unit_tpu.data.transforms import TransformConfig as JT
    from unit_tpu_torch.data.transforms import TransformConfig as TT

    tcfg, jcfg = both
    for make in ("train_from_cfg", "test_from_cfg"):
        t, j = getattr(TT, make)(tcfg), getattr(JT, make)(jcfg)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (make, f.name)


def test_prefetcher_pins_closes_and_forwards_errors():
    import torch

    items = [{"image": np.ones((2, 3), np.float32) * i, "ids": ["a", None]} for i in range(5)]
    with tloader.Prefetcher(iter(items), depth=2) as pf:
        assert [float(b["image"][0, 0]) for b in pf] == [0, 1, 2, 3, 4]

    def as_tensors(batch):
        return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}

    out = list(tloader.Prefetcher(iter(items), transform=as_tensors))
    assert isinstance(out[0]["image"], torch.Tensor) and out[0]["ids"] == ["a", None]

    def failing():
        yield items[0]
        raise OSError("disk gone")

    pf = tloader.Prefetcher(failing())
    next(pf)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    pf = tloader.Prefetcher(iter(lambda: items[0], None), depth=1)  # endless
    next(pf)
    pf.close()
    assert not pf.thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def first_batch(loader_and_n):
    loader, _ = loader_and_n
    try:
        return next(iter(loader))
    finally:
        loader.close()


def meta_model(cfg):
    with torch.device("meta"):  # shapes and structure only
        return WSRCNN(ModelConfig.from_cfg(cfg))


def with_proposals(cfg, files_key=None):
    cfg.MODEL.LOAD_PROPOSALS = True
    if files_key:  # a file that does not exist: no image gets a proposal
        setattr(cfg.DATASETS, files_key, ("p.pkl",))
    return cfg


@pytest.mark.parametrize("call,item", [
    # the TTA loader is ported (tests/test_torch_tta.py), and with it its
    # precomputed proposals (tests/test_torch_dock_data.py): the cases keep
    # their names and hold that the ported paths run (item None), here with
    # a proposal file that does not exist, so every slot is invalid
    pytest.param(lambda cfg: first_batch(tloader.build_tta_test_loader(
        with_proposals(cfg, "PROPOSAL_FILES_TEST"), "voc_base_training_query_val",
        image_loader=seeded_image_loader)), None, id="<lambda>-item 24"),
    pytest.param(lambda cfg: first_batch(tdata.build_test_loader(
        with_proposals(cfg, "PROPOSAL_FILES_TEST"), "voc_base_training_query_val",
        image_loader=seeded_image_loader)), None, id="<lambda>-item 23"),
    pytest.param(lambda cfg: next(iter(tdata.build_classifier_loader(
        with_proposals(cfg), image_loader=seeded_image_loader))), None,
        id="<lambda>-item 25_0"),
    # the uint8 wire is ported (tests/test_torch_host_uint8.py): its case
    # keeps its name and holds a strong stream's uint8 batch with proposals
    pytest.param(lambda cfg: (setattr(cfg.TPU, "HOST_TRANSFER_UINT8", True),
                              next(iter(tdata.build_strong_loader(
                                  with_proposals(cfg, "PROPOSAL_FILES_TRAIN"),
                                  image_loader=seeded_image_loader))))[1], None,
                 id="<lambda>-item 29"),
    pytest.param(lambda cfg: next(iter(tdata.build_strong_loader(
        with_proposals(cfg, "PROPOSAL_FILES_TRAIN"), image_loader=seeded_image_loader))), None,
        id="<lambda>-item 25_1"),
    # the COCO suites register, and the dock suite's model builds (shapes
    # only: tests/test_torch_dock.py holds its modules)
    pytest.param(lambda cfg: (cfg.merge_from_file("configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml"),
                              __import__("unit_tpu_torch.data.utils", fromlist=["x"])
                              .register_datasets(cfg, "unused"),
                              meta_model(cfg))[2],
                 None, id="<lambda>-items 22 and 25"),
])
def test_unported_data_paths_raise(both, call, item):
    """A data path still to port raises with its ROADMAP item; one ported
    since (item None) runs: a loader's first batch carries the proposal
    slots MODEL.LOAD_PROPOSALS asks for, and the dock model builds."""
    tcfg, _ = both
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            call(tcfg)
        return
    out = call(tcfg)
    if isinstance(out, dict):
        n = out["image"].shape[0]
        topk = (tcfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST if "image_id" in out
                else tcfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
        assert out["proposals"].shape == (n, topk, 4)
        assert out["proposals_valid"].shape == (n, topk) and not out["proposals_valid"].any()
        assert out["image"].dtype == (np.uint8 if tcfg.TPU.HOST_TRANSFER_UINT8 else np.float32)
    else:
        assert type(out.backbone).__name__ == "VGGCNNF"
