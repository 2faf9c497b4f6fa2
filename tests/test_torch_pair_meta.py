"""The meta stream over InceptionResNetV2 and VGG-CNN-F: unit_tpu_torch vs unit_tpu.

The note recipe (configs/COCO/COCO-RCNN-50-C4-split1-note.yaml) and the dock
recipe (configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml) with
MODEL.META_ARCHITECTURE WeaklySupervisedRCNN and MODEL.ROI_HEADS.NAME
WSROIHead: the note's meta Res5 over block17's 1088 channels, its shots
pooled at 17x17; the dock's over VGG-CNN-F's 256, its shots pooled by
ROIAlignV2 at 6x6 whatever its box pooler (ROIPool), as unit_tpu's are, and
its rank losses reading ROIPool's maps (6x6 -> 3x3).  The path tests of
tests/test_torch_pair_paths.py (a train step's losses and every gradient,
predict, the trainers) run here on these two paths, at its size and bounds;
and here alone: the prototypes, the dock's artifact with its attention head,
the note and dock suites' support loaders and their prototypes, and R21 (a
note or dock run with the meta heads fails on its support lookup in both
packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu.data.loader as jloader
import unit_tpu_torch.data as tdata
import unit_tpu_torch.data.loader as tloader
from tests.test_torch_data import assert_same_batch
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from tests.test_torch_pair_paths import (  # noqa: F401  (fixtures and the path tests)
    check_artifact,
    devkit,
    path_data,
    release_paths,
    suite_cfgs,
    test_path_builds_over_the_backbones_width,
    test_path_predict_matches,
    test_path_train_gradients_match,
    test_path_train_losses_match,
    test_trainers_take_the_paths_streams,
)
from tests.test_torch_pairs import (
    DOCK,
    META_KEYS,
    NOTE,
    make_pair,
    reduced_inception,  # noqa: F401  (autouse)
    t,
)
from unit_tpu.engine import runner as jrunner
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.engine import runner


@pytest.fixture(scope="module", params=["note_meta", "dock_meta"])
def path(request):
    return path_data(request.param)


def test_meta_path_prototypes_match(path):
    """compute_meta_attention alone: the support shots through the backbone
    and K1's plain version at the box pooler's resolution (17, or 6 on the
    dock, whose box pooler is ROIPool), the meta head over the backbone's
    channels: prototypes within 1e-4 of their largest magnitude."""
    jm, params, tm, meta = path["jm"], path["params"], path["tm"], path["meta"]
    load_jax_params(tm, jax.tree.map(np.asarray, params))

    def attention(p, s):
        a = jm.apply({"params": p}, s, method=JWSRCNN.compute_meta_attention)
        return a.mean, a.logdet

    mean, logdet = jax.tree.map(np.asarray, jax.jit(attention)(
        params, jax.tree.map(jnp.asarray, meta)))
    with torch.no_grad():
        got = tm.compute_meta_attention({k: t(v) for k, v in meta.items()})
    scale = np.abs(mean).max()
    assert scale > 0 and np.abs(got.mean.numpy() - mean).max() <= 1e-4 * scale
    np.testing.assert_array_equal(got.logdet.numpy(), logdet)


@pytest.mark.parametrize("path", ["dock_meta"], indirect=True)
def test_artifact_matches_the_live_predict(path, tmp_path):
    check_artifact(path, tmp_path)


# ------------------------------------------------- the suites' support sets
@pytest.mark.parametrize("yaml", [NOTE, DOCK], ids=["note", "dock"])
def test_a_meta_run_of_the_note_or_dock_fails_on_its_support_lookup_as_unit_tpus(yaml, devkit):
    """R21: FEWSHOT.TYPE COCO_NOTE / COCO_DOCK are not in unit_tpu's support
    mapping, which falls through to voc_base_training_support; on a COCO
    devkit that set is not registered, and building the trainer fails there
    in both packages (the suite's own set is registered)."""
    jcfg, tcfg = suite_cfgs(yaml, devkit, *META_KEYS)
    own = "coco_note_base_training_support" if yaml == NOTE else "coco_dock_base_training_support"
    assert own in jdata.DatasetCatalog and own in tdata.DatasetCatalog
    assert runner.support_dataset_name(tcfg) == "voc_base_training_support"
    with pytest.raises(KeyError, match="voc_base_training_support"):
        jrunner.build_everything(jcfg, num_devices=1, seed=0)
    with pytest.raises(KeyError, match="voc_base_training_support"):
        runner.build_everything(tcfg, torch.device("cpu"), seed=0)


@pytest.mark.parametrize("yaml", [NOTE, DOCK], ids=["note", "dock"])
def test_suite_support_sets_and_their_prototypes_match(yaml, devkit):
    """build_support_loader on the registered note and dock support sets,
    JPEGs read BGR in both (the note's INPUT.FORMAT "RGB" read by neither,
    R10; its NORMALIZE_IMAGES in the model's preprocess): batches
    bit-identical, and meta_attention over the set against unit_tpu's
    compute_meta_attention on its batch."""
    jcfg, tcfg = suite_cfgs(yaml, devkit, *META_KEYS)
    name = "coco_note_base_training_support" if yaml == NOTE else \
        "coco_dock_base_training_support"
    for deterministic in (False, True):
        got = next(iter(tloader.build_support_loader(tcfg, name, deterministic=deterministic)))
        want = next(iter(jloader.build_support_loader(jcfg, name,
                                                      deterministic=deterministic)))
        assert_same_batch(got, want)
    assert got["image"].shape[:2] == (len(tcfg.DATASETS.FEWSHOT.BASE_CLASSES_ID), 2)
    assert got["class_valid"].any()
    jm, params, tm = make_pair(jcfg, tcfg)
    tm.eval()
    att = runner.meta_attention(tcfg, tm, dataset_name=name)

    def attention(p, s):
        a = jm.apply({"params": p}, s, method=JWSRCNN.compute_meta_attention)
        return a.mean, a.logdet

    mean, logdet = jax.tree.map(np.asarray, jax.jit(attention)(
        params, jax.tree.map(jnp.asarray, dict(want))))
    scale = np.abs(mean).max()
    assert scale > 0 and np.abs(att.mean.numpy() - mean).max() <= 1e-4 * scale
    np.testing.assert_array_equal(att.logdet.numpy(), logdet)
    assert runner.meta_attention(tcfg, tm) is None  # R21: the evaluation's name
