"""unit_tpu_torch.config is its own copy of unit_tpu.config: same trees, same
validation.

For every YAML under configs/, the port's ``get_cfg()`` + ``merge_from_file``
gives the same plain dict as unit_tpu's, and ``validate_registry_names``
accepts and rejects the same names (exact comparisons: the files hold no
computed numbers).
"""

import glob
import os

import pytest

import unit_tpu.config as jconfig
import unit_tpu.config.validate as jvalidate
import unit_tpu_torch.config as tconfig
import unit_tpu_torch.config.validate as tvalidate
from unit_tpu.config.node import _to_plain as j_to_plain
from unit_tpu_torch.config.node import _to_plain as t_to_plain

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAMLS = sorted(os.path.relpath(p, ROOT) for p in
               glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))

REGISTRIES = ["META_ARCHITECTURES", "BACKBONES", "PROPOSAL_GENERATORS", "ROI_HEADS",
              "FAST_RCNN_PREDICTORS", "WEAK_DETECTORS", "VISUAL_ATTENTION_HEADS", "BOX_HEADS",
              "MASK_HEADS"]
NAME_KEYS = [
    "MODEL.META_ARCHITECTURE", "MODEL.BACKBONE.NAME", "MODEL.PROPOSAL_GENERATOR.NAME",
    "MODEL.ROI_HEADS.NAME", "MODEL.ROI_HEADS.FAST_RCNN.NAME",
    "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME",
    "MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME", "MODEL.ROI_BOX_HEAD.NAME",
    "MODEL.ROI_MASK_HEAD.NAME",
]


def test_the_port_has_its_own_classes():
    assert tconfig.CfgNode is not jconfig.CfgNode
    assert tconfig.CfgNode.__module__ == "unit_tpu_torch.config.node"
    assert tconfig.get_cfg.__module__ == "unit_tpu_torch.config.defaults"


def test_defaults_are_equal():
    assert t_to_plain(tconfig.get_cfg()) == j_to_plain(jconfig.get_cfg())
    assert tconfig.get_cfg().dump() == jconfig.get_cfg().dump()


@pytest.mark.parametrize("path", YAMLS)
def test_every_yaml_merges_to_the_same_tree(path):
    assert len(YAMLS) >= 20
    t, j = tconfig.get_cfg(), jconfig.get_cfg()
    t.merge_from_file(os.path.join(ROOT, path))
    j.merge_from_file(os.path.join(ROOT, path))
    assert t_to_plain(t) == j_to_plain(j)
    tconfig.validate_registry_names(t)
    jconfig.validate_registry_names(j)


def test_merge_from_list_freeze_and_clone_behave_alike():
    opts = ["SOLVER.BASE_LR", "0.5", "MODEL.RESNETS.DEPTH", "26", "SOLVER.STEPS", "(10, 20)",
            "DATASETS.TRAIN", "('a', 'b')", "TPU.COMPUTE_DTYPE", "float32"]
    t, j = tconfig.get_cfg(), jconfig.get_cfg()
    t.merge_from_list(opts)
    j.merge_from_list(opts)
    assert t_to_plain(t) == j_to_plain(j)
    for cfg in (t, j):
        with pytest.raises(AssertionError, match="Non-existent config key"):
            cfg.merge_from_list(["SOLVER.NO_SUCH_KEY", "1"])
        clone = cfg.clone()
        cfg.freeze()
        with pytest.raises(AttributeError):
            cfg.SOLVER.BASE_LR = 1.0
        clone.SOLVER.BASE_LR = 2.0
        assert cfg.SOLVER.BASE_LR == 0.5 and cfg.is_frozen() and not clone.is_frozen()


@pytest.mark.parametrize("registry", REGISTRIES)
def test_registries_are_equal(registry):
    assert getattr(tvalidate, registry) == getattr(jvalidate, registry)


@pytest.mark.parametrize("key", NAME_KEYS)
def test_unknown_names_are_rejected_alike(key):
    messages = []
    for mod in (tconfig, jconfig):
        cfg = mod.get_cfg()
        cfg.merge_from_list([key, "NoSuchThing"])
        with pytest.raises(KeyError) as err:
            mod.validate_registry_names(cfg)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and key in messages[0]


def test_abstract_predictor_name_is_rejected_alike():
    for mod in (tconfig, jconfig):
        cfg = mod.get_cfg()
        cfg.merge_from_list(["MODEL.ROI_HEADS.FAST_RCNN.NAME", "FastRCNNOutputsBase"])
        with pytest.raises(KeyError):
            mod.validate_registry_names(cfg)
