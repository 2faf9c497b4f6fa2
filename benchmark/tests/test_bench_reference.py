"""The reference against what it must agree with before any run: its
parameters and buffers by name and shape are the program's state dict (so
one dict of weights loads into both), the defaults it assumes are the
program's configuration defaults, and its drawing of a COCO polygon into a
box's frame is the dataset reader's."""

import numpy as np
import pytest

import bench_testlib as lib


def program_state(config: dict):
    import torch
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.models import WSRCNN, ModelConfig

    cfg = get_cfg()
    for part in ("recipe", "changed"):
        for key, value in config[part].items():
            cfg.merge_from_list([key, value])
    with torch.device("meta"):
        return cfg, WSRCNN(ModelConfig.from_cfg(cfg)).state_dict()


@pytest.mark.parametrize("name", ["voc-r101-c4.train", "coco-r50-c4-segm.train"])
@pytest.mark.parametrize("tiny", [False, True])
def test_state_names_and_shapes_are_the_programs(name, tiny):
    from harness import common

    cell = common.Cell(common.load_json(lib.ROOT, "BENCHMARK.json"), name)
    if tiny:
        cell.config["changed"].update(lib.TINY)
    ref = cell.reference
    r = ref.Recipe(cell.config)
    _, want = program_state(cell.config)
    got = {n: s for n, s, _ in ref.param_specs(r)}
    got.update({f"{n}.{k}": (c,) for n, c in ref.batch_norms(r)
                for k in ("weight", "bias", "mean", "var")})
    got["embeddings"] = (80, 300)
    assert got == {n: tuple(t.shape) for n, t in want.items()}


@pytest.mark.parametrize("name", ["voc-r101-c4.train", "coco-r50-c4-segm.train"])
def test_defaults_are_the_programs(name):
    from harness import common

    cell = common.Cell(common.load_json(lib.ROOT, "BENCHMARK.json"), name)
    r = cell.reference.Recipe(cell.config)
    cfg, _ = program_state(cell.config)
    for key in cell.reference.DEFAULTS:
        node = cfg
        for part in key.split("."):
            node = getattr(node, part)
        if isinstance(node, str):
            assert r[key] == node, key
        else:
            assert np.allclose(np.asarray(r[key], float), np.asarray(node, float)), key


def test_box_mask_is_the_readers():
    import ref_decode
    from harness import devkit
    from unit_tpu_torch.data.coco import polygons_to_boxmask

    rng = np.random.RandomState(0)
    for _ in range(40):
        x1, y1 = rng.randint(0, 300, 2)
        box = [int(x1), int(y1), int(x1 + rng.randint(8, 200)), int(y1 + rng.randint(8, 200))]
        poly = [float(v) for xy in devkit.ellipse_polygon(*box) for v in xy]
        bbox = [float(v) for v in box]
        assert np.array_equal(ref_decode.box_mask([poly], bbox, 28),
                              polygons_to_boxmask([poly], bbox, 28))
