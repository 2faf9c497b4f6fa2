"""inference_on_dataset of unit_tpu_torch vs unit_tpu's, on shared weights.

Both loops run the small flagship of tests/test_torch_slice.py (depth 26,
RES2_OUT_CHANNELS 64, 160x224 canvas, f32) over the test split of a synthetic
devkit and feed a recording evaluator.  The evaluator must receive the same
images in the same order, the padding of the last partial batch skipped, and
detections within the slice tolerance of test_torch_slice.py (scores 2e-3,
boxes 0.05 px, here in original-image coordinates), at batch size 1 (both
canvas orientations) and 3 (8 images: a partial last batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unit_tpu.data as jdata
import unit_tpu_torch.data as tdata
from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_data import seeded_image_loader, write_devkit
from tests.test_torch_slice import BOX_TOL, PROB_TOL, assert_same_detections, small_flagship_cfg
from unit_tpu.engine import make_predict_fn as jmake_predict_fn
from unit_tpu.evaluation import inference_on_dataset as jinference_on_dataset
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.config import get_cfg
from unit_tpu_torch.engine import make_predict_fn
from unit_tpu_torch.evaluation import inference_on_dataset
from unit_tpu_torch.models import WSRCNN, ModelConfig

NAME = "voc_base_training_query_val"


class Recorder:
    """An evaluator that keeps what it is given."""

    def __init__(self):
        self.seen = []

    def process(self, image_id, boxes, scores, classes, valid):
        boxes, scores, classes, valid = (np.array(a) for a in (boxes, scores, classes, valid))
        self.seen.append((image_id, [
            {"box": list(boxes[k]), "score": float(scores[k]), "class_id": int(classes[k])}
            for k in np.flatnonzero(valid)]))

    def evaluate(self):
        return {"bbox": {"AP50": float(len(self.seen))}}


@pytest.fixture(scope="module")
def pair():
    cfg = small_flagship_cfg()
    jmodel = JWSRCNN(mc=JModelConfig.from_cfg(cfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 160, 224, 3)),
                            jnp.asarray([[160.0, 224.0]]))
    params = randomize_params(variables["params"], seed=3)
    tmodel = WSRCNN(ModelConfig.from_cfg(cfg)).eval()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    jpredict = jmake_predict_fn(jmodel)
    return cfg, (lambda im, sz: jpredict(params, im, sz)), make_predict_fn(tmodel)


def port_cfg():
    cfg = get_cfg()
    cfg.merge_from_other_cfg(small_flagship_cfg())
    return cfg


@pytest.mark.parametrize("batch_size,sizes", [(1, ((100, 140), (140, 100))), (3, ((100, 140),))])
def test_the_evaluator_is_fed_alike(pair, tmp_path, batch_size, sizes):
    jcfg, jpredict, tpredict = pair
    tcfg = port_cfg()
    root = write_devkit(tmp_path / "devkit", sizes=sizes)
    for mod, cfg in ((tdata, tcfg), (jdata, jcfg)):
        mod.DatasetCatalog.clear()
        cfg.DATASETS.CLASSIFIER_DATAROOT = root
        mod.RegisterVOC(cfg, root).register_all()
    jl, jn = jdata.build_test_loader(jcfg, NAME, image_loader=seeded_image_loader,
                                     batch_size=batch_size)
    tl, tn = tdata.build_test_loader(tcfg, NAME, image_loader=seeded_image_loader,
                                     batch_size=batch_size)
    want, got = Recorder(), Recorder()
    jres = jinference_on_dataset(jpredict, jl, want, jn)
    tres = inference_on_dataset(tpredict, tl, got, tn)
    assert tn == jn == 8
    assert [i for i, _ in got.seen] == [i for i, _ in want.seen]
    assert len(got.seen) == 8  # padded slots of the last batch are skipped
    assert tres["bbox"] == jres["bbox"] == {"AP50": 8.0}
    assert tres["inference_seconds_per_image"] > 0
    n_det = 0
    records = {r["image_id"]: r for r in tdata.DatasetCatalog.get(NAME)}
    for (image_id, g), (_, w) in zip(got.seen, want.seen):
        assert_same_detections(g, w)
        n_det += len(g)
        h, w_ = records[image_id]["height"], records[image_id]["width"]
        for d in g:  # original-image coordinates, clipped to the image
            x1, y1, x2, y2 = d["box"]
            assert 0 <= x1 <= x2 <= w_ and 0 <= y1 <= y2 <= h
    assert n_det >= 8 and BOX_TOL == 0.05 and PROB_TOL == 2e-3


def test_no_warmup_times_everything_and_an_empty_loader_evaluates():
    calls = []

    def predict(images, sizes):
        from unit_tpu_torch.structures.instances import Detections

        calls.append(images.shape)
        b = images.shape[0]
        return Detections(boxes=torch.ones(b, 2, 4), scores=torch.ones(b, 2),
                          classes=torch.zeros(b, 2, dtype=torch.long),
                          valid=torch.ones(b, 2, dtype=torch.bool))

    batch = {"image": np.zeros((2, 8, 8, 3), np.float32), "image_size": np.ones((2, 2)),
             "image_id": ["a", None], "scale": np.asarray([2.0, 2.0]),
             "orig_size": np.asarray([[4.0, 4.0]] * 2)}
    rec = Recorder()
    res = inference_on_dataset(predict, iter([batch]), rec, 1, warmup=0)
    assert [i for i, _ in rec.seen] == ["a"] and rec.seen[0][1][0]["box"] == [0.5] * 4
    assert res["inference_seconds_per_image"] > 0 and len(calls) == 1
    res = inference_on_dataset(predict, iter([]), Recorder(), 0)
    assert "inference_seconds_per_image" not in res
