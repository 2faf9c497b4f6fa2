"""The one general generator: it reads a traffic mix's parameters
(``benchmark/traffic/<mix>.json``) and makes that mix's inputs from the seed.

``kind: train``  a dataset on disk in the layout the configuration's recipe
                 reads (VOCdevkit or COCO instances), ``images`` JPEGs of the
                 dataset's ``shapes``, ``boxes`` [lo, hi] instances each."""

from __future__ import annotations

import os

from . import devkit


def training_data(mix: dict, config: dict, seed: int, root: str) -> dict:
    """The dataset of a ``train`` mix written under ``root``; returns what was
    written by image id (``devkit.write_voc``, ``devkit.write_coco``)."""
    kind = config["dataset"]
    shapes = [tuple(s) for s in mix["shapes"][kind]]
    boxes = tuple(mix["boxes"])
    base = config["recipe"]["DATASETS.FEWSHOT.BASE_CLASSES_ID"]
    if kind == "VOC":
        return devkit.write_voc(root, seed, mix["images"], shapes, boxes, base)
    if kind == "COCO":
        return devkit.write_coco(root, seed, mix["images"], shapes, boxes, base,
                                 splits=mix["coco_splits"])
    raise ValueError(f"no dataset layout {kind!r}")


def scratch_dir(name: str) -> str:
    """A fresh directory for a run's data under TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix=name + "-", dir=os.environ.get("TMPDIR"))
