"""Host-side data loaders: strong query stream, weak classifier stream (and the
classifier datasets as a boxed strong stream), support stream, test set.

Port of unit_tpu/data/loader.py for one process: seeded numpy iterators that
emit fixed-shape batches.  Every random draw comes from the loader's own
``np.random.RandomState``, in unit_tpu's order, so a stream here equals
unit_tpu's record for record (tests/test_torch_data.py).  The weak classifier
stream reproduces the seeded per-class k-shot sampling with base/novel
multipliers and oversampling modes; the support stream (``SupportLoader``)
the per-class k-shot draws of the meta recipe; the TTA test loader
(``build_tta_test_loader``) the canonical image with its resized and flipped
variants.  Under MODEL.LOAD_PROPOSALS the batches carry precomputed proposals
(data/proposals.py: ``proposals`` [B, P, 4], ``proposals_valid`` [B, P], P =
DATASETS.PRECOMPUTED_PROPOSAL_TOPK_*): the strong and test loaders where
DATASETS.PROPOSAL_FILES_TRAIN / _TEST name files, the TTA loader in the
canonical frame only, and the classifier loader always, as unit_tpu's does
(fault R12 of ROADMAP.md: with no file in PROPOSAL_FILES_CLASSIFIER_TRAIN
every slot is invalid).  ``Prefetcher`` overlaps host IO with the device's
work and can hand out batches in pinned memory, from which the trainer's
upload is asynchronous.

A record of a JPEG file with its height and width goes through the C loader
(data/native.py: decode, resize, flip and canvas fill with the GIL
released) in the strong, classifier and test loaders wherever the library
builds, unless an ``image_loader`` is given; a file the C decoder refuses,
and any other record, goes through PIL and the numpy resize.  The TTA and
support loaders are numpy only, as unit_tpu's are.  Under
TPU.HOST_TRANSFER_UINT8 (``TransformConfig.host_uint8``) a stream batch's
images are rounded to uint8, 4x fewer bytes to upload; the model casts them
to f32 on the device.

Under data parallelism (``parallel``, one process a rank) the strong,
classifier, classifier-strong, test and TTA loaders read the records
``[data_rank::data_world]`` of their list (``_host_shard``),
SOLVER.IMS_PER_BATCH is the global batch, split evenly over the data ranks
(``_per_host_batch``), and the training streams draw each batch's canvas
orientation from one schedule that every rank shares
(``StreamLoader(sync_portrait_frac=...)``, the portrait share of the whole
list): every rank's batch of a step has the same shape, so
``TPU.GRAD_ACCUM`` groups form alike everywhere.  The data ranks are the
ranks, except in the training streams under TPU.TP and TPU.PP, whose model
(or stage) ranks of one data rank read the same records
(``parallel.comm.data_rank``): under PP the first and the last stage then
pair the same strong and weak groups on one canvas without a message; the test
loaders feed whole replicas and split over every rank.  The support stream
is not split: every rank reads the same shots, as in unit_tpu.
"""

from __future__ import annotations

import itertools
import queue as queue_lib
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..parallel import comm
from . import native
from .catalog import DatasetCatalog
from .proposals import attach_proposals
from .transforms import (
    TransformConfig, collate, load_image_bgr, max_aspect_of, oriented_canvas,
    prepare_detection_record, prepare_test_image, resize_image, tta_canvas_for,
)

_STRONG_KEYS = ("image", "image_size", "gt_boxes", "gt_classes", "gt_valid")
_WEAK_KEYS = ("image", "image_size", "labels")
_PROPOSAL_KEYS = ("proposals", "proposals_valid")


def sample_classifier_dataset(cfg, records: List[dict]) -> List[dict]:
    """Seeded k-shot image-level sampling (reference data/build.py:356-438).

    Each (image, class) pair becomes a record whose annotations carry only that
    class; base classes keep all records (or sample_num * BASE_MULTIPLIER),
    novel classes are subsampled to WEAK_CLASSIFIER_SAMPLE_NUM (optionally
    repeated/oversampled).
    """
    sample_num = cfg.DATASETS.WEAK_CLASSIFIER_SAMPLE_NUM
    if sample_num <= 0:
        return records
    rng = np.random.RandomState(cfg.DATASETS.SAMPLE_SEED)
    num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    base_ids = set(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)

    label_to_records: Dict[int, List[dict]] = {c: [] for c in range(num_classes)}
    for rec in records:
        seen = {}
        for ann in rec["annotations"]:
            cid = ann["category_id"]
            if cid not in seen:
                r = dict(rec)
                r["annotations"] = [ann]
                seen[cid] = r
            else:
                seen[cid]["annotations"].append(ann)
        for cid, r in seen.items():
            if cid in label_to_records:
                label_to_records[cid].append(r)

    def choice(pool, size, replace):
        idx = rng.choice(len(pool), size=size, replace=replace)
        return [pool[i] for i in idx]

    out: List[dict] = []
    for cid, pool in label_to_records.items():
        if not pool:
            continue
        if cid in base_ids:
            if not cfg.DATASETS.OVER_SAMPLE and cfg.DATASETS.BASE_MULTIPLIER > 0:
                size = int(sample_num * cfg.DATASETS.BASE_MULTIPLIER)
                sampled = choice(pool, size, replace=size > len(pool))
            else:
                sampled = pool
        else:
            if not cfg.DATASETS.OVER_SAMPLE:
                if cfg.DATASETS.BASE_MULTIPLIER > 0:
                    sampled = choice(pool, sample_num, replace=sample_num > len(pool))
                    if cfg.DATASETS.NOVEL_MULTIPLER > 0:
                        sampled = [
                            r for r in sampled for _ in range(int(cfg.DATASETS.NOVEL_MULTIPLER))
                        ]
                else:
                    sampled = []
            else:
                k = choice(pool, min(sample_num, len(pool)), replace=False)
                if not cfg.DATASETS.SAMPLE_WITH_REPLACEMENT:
                    sampled = choice(k, len(pool), replace=True)
                else:
                    reps, rem = divmod(len(pool), len(k))
                    sampled = list(
                        itertools.chain.from_iterable([r] * reps for r in k)
                    )
                    if rem:
                        sampled += choice(k, rem, replace=True)
        out.extend(sampled)
    return out


class StreamLoader:
    """Infinite shuffled iterator over records -> fixed-shape batches."""

    def __init__(
        self,
        records: List[dict],
        tcfg: TransformConfig,
        batch_size: int,
        keys: Sequence[str],
        seed: int = 0,
        training: bool = True,
        image_loader: Optional[Callable[[dict], np.ndarray]] = None,
        sync_portrait_frac: Optional[float] = None,
    ):
        if not records:
            raise ValueError("empty dataset")
        self.records = records
        self.tcfg = tcfg
        self.batch_size = batch_size
        self.keys = keys
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.training = training
        self.image_loader = image_loader
        # Data parallelism: every rank must emit the same batch shape each
        # step.  When set, a batch's canvas orientation is drawn from a
        # schedule all ranks share (same seed, same global portrait share),
        # while each rank samples its own record shard.
        self.sync_portrait_frac = sync_portrait_frac
        self._resume = None
        self._resume_synced = None

    def _draw_aug(self):
        """The ONLY rng draws per record (min-size choice + flip coin).  Both
        `_load` and `fast_forward` consume this exact sequence, so a resumed
        stream replays the same augmentations without decoding anything."""
        t = self.tcfg
        min_size = (
            t.min_sizes[self.rng.randint(len(t.min_sizes))]
            if self.training else t.min_sizes[0]
        )
        flip = bool(self.training and t.flip and self.rng.rand() < 0.5)
        return min_size, flip

    def _load(self, rec, aug=None):
        # the augmentation is drawn once, up front: the C path and the PIL
        # fallback consume the same draws, so a file the C decoder refuses
        # does not shift the stream of every record after it
        min_size, flip = aug if aug is not None else self._draw_aug()
        if self.image_loader is None and _native_eligible(rec):
            try:
                return self._load_native(rec, min_size, flip)
            except RuntimeError:
                pass  # not decodable in C: PIL
        img = self.image_loader(rec) if self.image_loader else None
        return prepare_detection_record(rec, self.tcfg, self.rng, image=img,
                                        training=self.training, aug=(min_size, flip))

    def _load_native(self, rec, min_size: int, flip: bool):
        """Decode, resize, flip and canvas in C; the annotations in Python."""
        t = self.tcfg
        canvas = oriented_canvas(int(rec["height"]), int(rec["width"]), t.canvas)
        image, (nh, nw), scale = native.prepare_image_native(
            rec["file_name"], min_size, t.max_size, canvas, flip)
        return prepare_detection_record(rec, t, self.rng, training=self.training,
                                        preprocessed=(image, nh, nw, scale, flip))

    def _emit(self, batch):
        out = collate(batch, self.keys)
        if self.tcfg.host_uint8 and "image" in out:
            # the uint8 wire: the bilinear values rounded back to the decode's
            # uint8 (at most 0.5 off), 4x fewer bytes to upload
            out["image"] = np.clip(np.rint(out["image"]), 0, 255).astype(np.uint8)
        return out

    def _synced(self) -> bool:
        """Whether the shared orientation schedule applies: on a square
        canvas every batch has one shape anyway, and the plain bucketing runs."""
        return self.sync_portrait_frac is not None and self.tcfg.canvas[0] != self.tcfg.canvas[1]

    def __iter__(self) -> Iterator[dict]:
        """Aspect-ratio-grouped batching (d2 AspectRatioGroupedDataset):
        landscape and portrait samples go to separate buckets (two fixed
        canvases), a batch is emitted whenever one bucket fills.  With
        ``sync_portrait_frac`` each batch's orientation follows the schedule
        the ranks share (``_iter_synced``)."""
        if self._synced():
            yield from self._iter_synced()
            return
        order: List[int] = []
        buckets: Dict[tuple, List[dict]] = {}
        if self._resume is not None:
            # fast_forward left the stream mid-epoch: records already drawn
            # into partially-filled buckets are decoded NOW with their
            # recorded augmentation draws (at most batch_size-1 per bucket).
            order, bucket_meta = self._resume
            self._resume = None
            buckets = {
                key: [self._load(self.records[i], aug=aug) for i, aug in metas]
                for key, metas in bucket_meta.items()
            }
        while True:
            if not order:
                order = list(self.rng.permutation(len(self.records)))
            sample = self._load(self.records[order.pop()])
            key = sample["image"].shape[:2]
            buckets.setdefault(key, []).append(sample)
            if len(buckets[key]) == self.batch_size:
                batch, buckets[key] = buckets[key], []
                yield self._emit(batch)

    def _orientations(self):
        """(is_portrait of each record, the orientations present, the
        schedule's generator): the schedule is seeded alike on every rank."""
        is_portrait = [int(r["height"]) > int(r["width"]) for r in self.records]
        have = {True: any(is_portrait), False: not all(is_portrait)}
        return is_portrait, have, np.random.RandomState((self.seed + 0x5EED) % 2**31)

    def _want(self, orient_rng, have) -> bool:
        """The next batch's orientation (True: portrait); raises where this
        rank's shard has none of it."""
        want = bool(orient_rng.rand() < self.sync_portrait_frac)
        if not have[want]:
            raise RuntimeError(
                f"this rank's record shard has no {'portrait' if want else 'landscape'} "
                f"images but the whole list does: the orientation schedule the ranks "
                f"share cannot be kept; use more records a rank or a square canvas")
        return want

    def _iter_synced(self) -> Iterator[dict]:
        """The shared orientation schedule (unit_tpu's ``_iter_synced``): a
        record's orientation is known from its height and width, so records
        are picked to match the scheduled orientation, not loaded on the chance."""
        is_portrait, have, orient_rng = self._orientations()
        order: List[int] = []
        pend: Dict[bool, List[int]] = {True: [], False: []}
        if self._resume_synced is not None:
            orient_rng, order, pend = self._resume_synced
            self._resume_synced = None
        while True:
            want = self._want(orient_rng, have)
            batch = []
            while len(batch) < self.batch_size:
                if pend[want]:
                    batch.append(self._load(self.records[pend[want].pop()]))
                    continue
                if not order:
                    order = list(self.rng.permutation(len(self.records)))
                i = order.pop()
                pend[is_portrait[i]].append(i)
            yield self._emit(batch)

    def _fast_forward_synced(self, n_batches: int) -> None:
        """``fast_forward`` for the shared orientation schedule: replays its
        orientation draws, record pops and augmentation draws (made as a
        batch is assembled, so the pending lists carry no augmentation and
        nothing is decoded)."""
        is_portrait, have, orient_rng = self._orientations()
        order: List[int] = []
        pend: Dict[bool, List[int]] = {True: [], False: []}
        for _ in range(n_batches):
            want = self._want(orient_rng, have)
            n = 0
            while n < self.batch_size:
                if pend[want]:
                    pend[want].pop()
                    self._draw_aug()
                    n += 1
                    continue
                if not order:
                    order = list(self.rng.permutation(len(self.records)))
                i = order.pop()
                pend[is_portrait[i]].append(i)
        self._resume_synced = (orient_rng, order, pend)

    def fast_forward(self, n_batches: int) -> None:
        """Advance the stream past ``n_batches`` WITHOUT decoding any image.

        Exact-resume support (--resume): replays the index-permutation and
        augmentation rng draws the real iterator would have consumed, then
        pre-positions the next ``__iter__`` so batch ``n_batches`` onward is
        bit-identical to an un-resumed run's.
        """
        if n_batches <= 0:
            return
        if self._synced():
            self._fast_forward_synced(n_batches)
            return
        order: List[int] = []
        buckets: Dict[tuple, List[tuple]] = {}  # key -> [(rec_idx, aug)]
        done = 0
        while done < n_batches:
            if not order:
                order = list(self.rng.permutation(len(self.records)))
            i = order.pop()
            aug = self._draw_aug()
            rec = self.records[i]
            key = oriented_canvas(
                int(rec["height"]), int(rec["width"]), self.tcfg.canvas
            )
            buckets.setdefault(key, []).append((i, aug))
            if len(buckets[key]) == self.batch_size:
                buckets[key] = []
                done += 1
        self._resume = (order, {k: v for k, v in buckets.items() if v})


def _model_ranks(cfg) -> int:
    """The ranks that share each data rank's images in training: TPU.PP's
    stage ranks (TPU.PP_STAGES) or TPU.TP's model ranks
    (``parallel.comm.data_rank``), else 1."""
    if getattr(cfg.TPU, "PP", False):
        return int(cfg.TPU.PP_STAGES or 2)
    return int(getattr(cfg.TPU, "TP", 1) or 1)


def _host_shard(records: List[dict], model_ranks: int = 1) -> List[dict]:
    """This data rank's records, ``[data_rank::data_world]`` (the reference's
    per-rank DistributedSampler; unit_tpu's host shard): the ``model_ranks``
    ranks of one data rank read the same records.  One data rank: all of
    them."""
    n = comm.data_world(model_ranks)
    return records[comm.data_rank(model_ranks)::n] if n > 1 else records


def _sync_portrait_frac(records: List[dict], model_ranks: int = 1) -> Optional[float]:
    """The portrait share of the WHOLE record list, for the orientation
    schedule the data ranks share; computed before ``_host_shard``, so every
    rank derives the same value.  One data rank: None (plain bucketing)."""
    if comm.data_world(model_ranks) <= 1:
        return None
    n = sum(1 for r in records if int(r["height"]) > int(r["width"]))
    return n / max(len(records), 1)


def _per_host_batch(global_batch: int, model_ranks: int = 1) -> int:
    """SOLVER.IMS_PER_BATCH is the global batch (the reference's semantics:
    split across workers), so each data rank loads its share; it must divide."""
    n = comm.data_world(model_ranks)
    if global_batch % n:
        raise ValueError(f"SOLVER.IMS_PER_BATCH={global_batch} is not divisible by the "
                         f"{n} ranks")
    return global_batch // n


def _with_proposals(records: List[dict], tcfg: TransformConfig, files, topk: int) -> None:
    """Attach the files' top-``topk`` proposals to ``records`` (in place)
    and make ``tcfg`` pad them to ``topk`` slots."""
    attach_proposals(records, files, topk)
    tcfg.proposal_capacity = topk


def build_strong_loader(cfg, dataset_names=None, seed=0, image_loader=None,
                        batch_size=None) -> StreamLoader:
    """The strong (box-labelled) stream; with MODEL.LOAD_PROPOSALS and
    DATASETS.PROPOSAL_FILES_TRAIN its batches carry those proposals (then the
    RPN neither proposes nor trains on them)."""
    names = dataset_names or cfg.DATASETS.TRAIN
    records = list(itertools.chain.from_iterable(DatasetCatalog.get(n) for n in names))
    m = _model_ranks(cfg)
    sync_frac = _sync_portrait_frac(records, m)
    records = _host_shard(records, m)
    keys = _STRONG_KEYS + (("gt_masks",) if cfg.MODEL.MASK_ON else ())
    tcfg = TransformConfig.train_from_cfg(cfg)
    if cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TRAIN:
        _with_proposals(records, tcfg, cfg.DATASETS.PROPOSAL_FILES_TRAIN,
                        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
        keys = keys + _PROPOSAL_KEYS
    return StreamLoader(records, tcfg,
                        batch_size or _per_host_batch(cfg.SOLVER.IMS_PER_BATCH, m), keys,
                        seed=seed, image_loader=image_loader, sync_portrait_frac=sync_frac)


def build_classifier_loader(cfg, seed=1, image_loader=None, batch_size=None) -> StreamLoader:
    """The weak (image-labelled) stream.  Under MODEL.LOAD_PROPOSALS its
    batches carry proposals whether or not DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN
    names a file, as unit_tpu's do: without one, every slot is invalid (R12)."""
    names = cfg.DATASETS.CLASSIFIER_TRAIN
    if isinstance(names, str):
        names = (names,)
    records = list(itertools.chain.from_iterable(DatasetCatalog.get(n) for n in names))
    records = sample_classifier_dataset(cfg, records)
    m = _model_ranks(cfg)
    sync_frac = _sync_portrait_frac(records, m)
    records = _host_shard(records, m)
    tcfg = TransformConfig.train_from_cfg(cfg)
    keys = _WEAK_KEYS
    if cfg.MODEL.LOAD_PROPOSALS:
        _with_proposals(records, tcfg, cfg.DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN,
                        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
        keys = keys + _PROPOSAL_KEYS
    return StreamLoader(records, tcfg,
                        batch_size or _per_host_batch(cfg.SOLVER.IMS_PER_BATCH, m), keys,
                        seed=seed, image_loader=image_loader, sync_portrait_frac=sync_frac)


def build_classifier_strong_loader(cfg, seed=0, image_loader=None,
                                   batch_size=None) -> StreamLoader:
    """The classifier datasets served as a boxed strong stream
    (TrainerOnlyWeakFineTune): sampled as the weak stream is, then only the
    records with annotations, with the strong stream's keys."""
    names = cfg.DATASETS.CLASSIFIER_TRAIN
    if isinstance(names, str):
        names = (names,)
    records = list(itertools.chain.from_iterable(DatasetCatalog.get(n) for n in names))
    records = [r for r in sample_classifier_dataset(cfg, records) if r.get("annotations")]
    m = _model_ranks(cfg)
    sync_frac = _sync_portrait_frac(records, m)
    records = _host_shard(records, m)
    keys = _STRONG_KEYS + (("gt_masks",) if cfg.MODEL.MASK_ON else ())
    return StreamLoader(
        records, TransformConfig.train_from_cfg(cfg),
        batch_size or _per_host_batch(cfg.SOLVER.IMS_PER_BATCH, m), keys, seed=seed,
        image_loader=image_loader, sync_portrait_frac=sync_frac,
    )


def build_test_loader(cfg, dataset_name: str, image_loader=None, batch_size=1):
    """Finite iterator over a test dataset and its length; yields per-batch
    dicts plus metadata (image_id, scale, orig_size) for the evaluator, and
    with MODEL.LOAD_PROPOSALS and DATASETS.PROPOSAL_FILES_TEST the images'
    proposals.  The final partial batch is padded with copies whose
    ``image_id`` is None.  The iterator is a background Prefetcher, so host
    prep overlaps the device.  Under data parallelism a rank reads its shard
    (``_host_shard``): whoever feeds the evaluator GT feeds the same shard."""
    records = _host_shard(DatasetCatalog.get(dataset_name))
    tcfg = TransformConfig.test_from_cfg(cfg)
    extra_keys = ()
    if cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TEST:
        _with_proposals(records, tcfg, cfg.DATASETS.PROPOSAL_FILES_TEST,
                        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
        extra_keys = _PROPOSAL_KEYS
    load_one = _make_test_record_loader(tcfg, np.random.RandomState(0), image_loader)

    def gen():
        batch = []
        for rec in records:
            batch.append(load_one(rec))
            if len(batch) == batch_size:
                yield _finalize_test_batch(batch, extra_keys)
                batch = []
        if batch:
            while len(batch) < batch_size:  # pad the final partial batch
                pad = {k: np.copy(v) for k, v in batch[-1].items()}
                pad["image_id"] = None
                batch.append(pad)
            yield _finalize_test_batch(batch, extra_keys)

    return Prefetcher(gen(), depth=4), len(records)


def _native_eligible(rec) -> bool:
    """A JPEG file with its size in the record, and the C loader built."""
    return (str(rec.get("file_name", "")).lower().endswith((".jpg", ".jpeg"))
            and "height" in rec and "width" in rec and native.available())


def _make_test_record_loader(tcfg, rng, image_loader):
    """record -> prepared test sample, through the C loader where it can."""
    def load_one(rec):
        if image_loader is None and _native_eligible(rec):
            canvas = oriented_canvas(int(rec["height"]), int(rec["width"]), tcfg.canvas)
            try:
                image, (nh, nw), scale = native.prepare_image_native(
                    rec["file_name"], tcfg.min_sizes[0], tcfg.max_size, canvas)
                return prepare_detection_record(rec, tcfg, rng, training=False,
                                                preprocessed=(image, nh, nw, scale))
            except RuntimeError:
                pass  # not decodable in C: PIL
        img = image_loader(rec) if image_loader else None
        return prepare_detection_record(rec, tcfg, rng, image=img, training=False)

    return load_one


def _finalize_test_batch(batch, extra_keys=()):
    out = collate(batch, ("image", "image_size") + tuple(extra_keys))
    out["image_id"] = [s["image_id"] for s in batch]
    out["scale"] = np.asarray([s["scale"] for s in batch])
    out["orig_size"] = np.stack([s["orig_size"] for s in batch])
    out["gt_boxes"] = np.stack([s["gt_boxes"] for s in batch])
    out["gt_classes"] = np.stack([s["gt_classes"] for s in batch])
    out["gt_valid"] = np.stack([s["gt_valid"] for s in batch])
    return out


def tta_variant_configs(cfg, max_aspect: float) -> List[tuple]:
    """[(TransformConfig, flip)] of TEST.AUG's variants in unit_tpu's order:
    each of MIN_SIZES on its tight canvas (``tta_canvas_for`` at the
    dataset's ``max_aspect``), then its flipped twin under FLIP."""
    base_t = TransformConfig.test_from_cfg(cfg)
    out = []
    for ms in cfg.TEST.AUG.MIN_SIZES:
        t = TransformConfig(
            min_sizes=(ms,), max_size=cfg.TEST.AUG.MAX_SIZE,
            canvas=tta_canvas_for(ms, cfg.TEST.AUG.MAX_SIZE, cfg.TPU.SIZE_DIVISIBILITY,
                                  max_aspect),
            flip=False, max_gt=base_t.max_gt, num_classes=base_t.num_classes)
        out.append((t, False))
        if cfg.TEST.AUG.FLIP:
            out.append((t, True))
    return out


def prepare_tta_batch(record: dict, image: np.ndarray, base_t: TransformConfig,
                      variant_cfgs: Sequence[tuple]) -> dict:
    """One record's TTA batch (batch size 1): the canonical image, size,
    scale and id as ``build_test_loader`` gives them (and its proposals, in
    the canonical frame, where ``base_t`` has a proposal capacity), and
    ``variants``, a list of {image [1, h, w, 3], image_size [1, 2], scale
    (over the canonical scale), flip}.  A flipped variant mirrors its content
    region only, never the padding."""
    canonical = prepare_detection_record(record, base_t, None, image=image, training=False)
    variants = []
    for t, flip in variant_cfgs:
        v = prepare_test_image(image, t)
        vimg = v["image"]
        if flip:
            nh, nw = int(v["image_size"][0]), int(v["image_size"][1])
            vimg[:nh, :nw] = vimg[:nh, :nw][:, ::-1].copy()
        variants.append({"image": vimg[None], "image_size": v["image_size"][None],
                         "scale": float(v["scale"] / canonical["scale"]), "flip": flip})
    out = {
        "image": canonical["image"][None],
        "image_size": canonical["image_size"][None],
        "image_id": [canonical["image_id"]],
        "scale": np.asarray([canonical["scale"]]),
        "orig_size": canonical["orig_size"][None],
        "variants": variants,
    }
    for k in _PROPOSAL_KEYS:
        if k in canonical:
            out[k] = canonical[k][None]
    return out


def build_tta_test_loader(cfg, dataset_name: str, image_loader=None):
    """Test loader for TTA inference (TEST.AUG; unit_tpu loader.py:532-610):
    per image the canonical batch plus one resized (and flipped) variant per
    TEST.AUG.MIN_SIZES entry, batch size 1.  The many resizes of an image are
    heavy host work: a Prefetcher at depth 2 makes them while the device runs
    the previous image.  With MODEL.LOAD_PROPOSALS and
    DATASETS.PROPOSAL_FILES_TEST each batch carries the image's proposals in
    the canonical frame; ``predict_tta`` rescales them for every variant.
    Returns (loader, number of images of this rank's shard); close the
    loader when done."""
    records = _host_shard(DatasetCatalog.get(dataset_name))
    base_t = TransformConfig.test_from_cfg(cfg)
    if cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TEST:
        _with_proposals(records, base_t, cfg.DATASETS.PROPOSAL_FILES_TEST,
                        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
    variant_cfgs = tta_variant_configs(cfg, max_aspect_of(records))

    def gen():
        for rec in records:
            img = image_loader(rec) if image_loader else load_image_bgr(rec["file_name"])
            yield prepare_tta_batch(rec, img, base_t, variant_cfgs)

    return Prefetcher(gen(), depth=2), len(records)


class SupportLoader:
    """The per-class k-shot support stream of the meta recipe (unit_tpu
    loader.py:613-698).

    Train mode: ``shots`` random records of each class a batch, drawn with
    ``randint`` class by class from one ``RandomState(seed)``; deterministic
    mode (the evaluation's prototypes): each class's records in order, in
    chunks of ``shots``, cycling.  A batch is
    {image [C, K, m, m, 3], boxes [C, K, 4], class_valid [C]}: each shot
    resized to the square meta canvas m (INPUT.META_MIN_SIZE) with the first
    of its GT boxes of the class, or the whole canvas where it has none; a
    class without records has zero shots and ``class_valid`` false.
    """

    def __init__(
        self,
        records_by_class: dict,
        class_ids: Sequence[int],
        shots: int,
        meta_size: int = 224,
        seed: int = 0,
        deterministic: bool = False,
        image_loader: Optional[Callable[[dict], np.ndarray]] = None,
    ):
        self.by_class = records_by_class
        self.class_ids = list(class_ids)
        self.shots = shots
        self.meta_size = meta_size
        self.rng = np.random.RandomState(seed)
        self.deterministic = deterministic
        self.image_loader = image_loader
        self._det_pos = {c: 0 for c in self.class_ids}

    def _prepare_shot(self, rec, class_id):
        img = self.image_loader(rec) if self.image_loader else load_image_bgr(rec["file_name"])
        h, w = img.shape[:2]
        m = self.meta_size
        out = resize_image(img.astype(np.float32), m, m)  # square meta resize
        sy, sx = m / h, m / w
        for ann in rec["annotations"]:
            if ann["category_id"] == class_id:
                b = ann["bbox"]
                return out, np.asarray([b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy], np.float32)
        return out, np.asarray([0, 0, m, m], np.float32)

    def _draws(self, cls, pool):
        """The pool indices of one class's shots in the next batch."""
        if self.deterministic:
            start = self._det_pos[cls]
            self._det_pos[cls] = (start + self.shots) % len(pool)
            return [(start + i) % len(pool) for i in range(self.shots)]
        return self.rng.randint(0, len(pool), size=self.shots)

    def __iter__(self):
        while True:
            yield self.next_batch()

    def fast_forward(self, n_batches: int) -> None:
        """Advance the stream past ``n_batches`` without loading a shot
        (exact --resume, as StreamLoader.fast_forward)."""
        for _ in range(max(0, n_batches)):
            for cls in self.class_ids:
                pool = self.by_class.get(cls, [])
                if pool:
                    self._draws(cls, pool)

    def next_batch(self):
        c, k, m = len(self.class_ids), self.shots, self.meta_size
        images = np.zeros((c, k, m, m, 3), np.float32)
        boxes = np.zeros((c, k, 4), np.float32)
        valid = np.zeros((c,), bool)
        for ci, cls in enumerate(self.class_ids):
            pool = self.by_class.get(cls, [])
            if not pool:
                continue
            valid[ci] = True
            for ki, idx in enumerate(self._draws(cls, pool)):
                images[ci, ki], boxes[ci, ki] = self._prepare_shot(pool[idx], cls)
        return {"image": images, "boxes": boxes, "class_valid": valid}


def build_support_loader(cfg, dataset_name: str = "voc_base_training_support", seed=2,
                         deterministic=False, image_loader=None) -> SupportLoader:
    """The support stream of ``dataset_name`` (records by class): NUM_SHOTS
    random shots a class for training, BASE_META_SHOTS in order with
    ``deterministic`` (the evaluation's prototypes)."""
    return SupportLoader(
        DatasetCatalog.get(dataset_name),
        class_ids=list(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID),
        shots=cfg.DATASETS.BASE_META_SHOTS if deterministic else cfg.DATASETS.FEWSHOT.NUM_SHOTS,
        meta_size=cfg.INPUT.META_MIN_SIZE,
        seed=seed,
        deterministic=deterministic,
        image_loader=image_loader,
    )


def pin_batch(batch):
    """A batch dict with every numeric array as a torch tensor in pinned
    (page-locked) memory, from which ``.to(device, non_blocking=True)`` is an
    asynchronous copy; other values pass through."""
    import torch

    if not isinstance(batch, dict):
        return batch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            if isinstance(v, np.ndarray) and v.dtype.kind in "biuf" else v
            for k, v in batch.items()}


class _PrefetchError:
    """Envelope forwarding a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_PREFETCH_DONE = object()


def _prefetch_worker(it, q, stop, sentinel, transform):
    # Module-level so the thread does NOT hold a reference to the Prefetcher:
    # an abandoned Prefetcher then becomes garbage, its __del__ sets `stop`,
    # and the thread exits instead of reading disk forever.
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    try:
        for item in it:
            if transform is not None:
                item = transform(item)
            if not put(item) or stop.is_set():
                return
        put(sentinel)
    except BaseException as e:  # noqa: BLE001 — forwarded, re-raised by consumer
        if not stop.is_set():
            put(_PrefetchError(e))


class Prefetcher:
    """Background-thread prefetch of an iterator (replaces DataLoader workers).

    Closeable: ``close()`` (also via ``with`` or garbage collection) signals the
    producer thread to stop, so abandoned iterators do not leak a thread that
    keeps reading disk.  Producer exceptions are re-raised in the consumer.
    ``transform`` (e.g. :func:`pin_batch`) runs on each item in the producer
    thread."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self.q: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=_prefetch_worker, args=(it, self.q, self._stop, _PREFETCH_DONE, transform),
            daemon=True,
        )
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self.q.get()
        if item is _PREFETCH_DONE:
            raise StopIteration
        if isinstance(item, _PrefetchError):
            raise item.exc
        return item

    def close(self, timeout: float = 5.0):
        self._stop.set()
        try:  # drain so a blocked producer unblocks immediately
            while True:
                self.q.get_nowait()
        except queue_lib.Empty:
            pass
        self.thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # only signal — joining from a finalizer is unsafe
        self._stop.set()
