"""A training cell: the recipe's trainer built as ``engine/runner.py`` builds
it, fed by the port's own loader from a seeded dataset of JPEG files, timed
over a window of steps, and held to the plain reference.

Set-up: the dataset, the weights (``weights.make_state``), the trainer
(``runner.build_everything``) loaded with them, the first ``check_steps``
steps (the reference repeats them after the window on batches it makes
again from the dataset's files: their losses, the first gradient as SGD
takes it, each leaf's change after the first update and after the last),
then warm-up steps until every pair of canvas orientations of the two
streams has run.
Window: ``run_step`` until ``seconds`` have passed, then ``drain`` and a
synchronise; images/s is every image of every step over that wall time.
A traced run profiles ``traced_steps`` steps after ``trace_skip_steps`` of
the window (synchronised before, so only they are on the device)."""

from __future__ import annotations

import gc
import math
import os
import shutil
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from counts import flops as cflops
from counts import peaks

from . import common, probes, traffic, weights
from .trace import Tracer, summarize

def program_cfg(config: dict, data_root: str, seed: int, output_dir: str):
    from unit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    for part in ("recipe", "changed"):
        for key, value in config[part].items():
            cfg.merge_from_list([key, value])
    cfg.merge_from_list(["DATASETS.CLASSIFIER_DATAROOT", data_root, "SEED", seed,
                         "OUTPUT_DIR", output_dir,
                         "MODEL.ROI_HEADS.EMBEDDING_PATH", weights.GLOVE])
    cfg.freeze()
    return cfg


def arch_of(config: dict) -> dict:
    r, a = config["recipe"], config["arch"]
    return {"depth": r["MODEL.RESNETS.DEPTH"], "freeze_at": r["MODEL.BACKBONE.FREEZE_AT"],
            "multi_box_head": r["MODEL.ROI_HEADS.MULTI_BOX_HEAD"],
            "mask_on": r["MODEL.MASK_ON"], "num_classes": r["MODEL.ROI_HEADS.NUM_CLASSES"],
            "rpn_dim": a["rpn_dim"], "rpn_anchors": a["rpn_anchors"]}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The worst leaf's gap of norms: |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def median_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The median leaf's gap of norms (``leaf_gap``'s measure)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def compare(prog: dict, ref: dict, round_off: float) -> Dict[str, float]:
    """Every number a training cell can compare with the reference:

    step1.<term>      each loss term's relative gap at the first step (from
                      the same state: no update between the two sides yet)
    loss_gap          the worst step's relative gap of total loss
    grad_gap          the worst leaf's gap of the first gradient's norm as
                      SGD takes it (clipped, with weight decay: the momentum
                      buffer after one step; ``leaf_gap``)
    grad_median       the median leaf's gap of the same
    change1_gap       the worst leaf's gap of the change's norm after the
                      first update (the learning rate and momentum at work,
                      before a second step's pseudo-labels can differ)
    change1_median    the median leaf's gap of the same
    change_gap        the worst leaf's gap of the change's norm after the
                      steps, over the leaves the reference's gradient moves
                      (a leaf under ``round_off`` of the median leaf's
                      gradient moves by round-off alone and is left out)
    change_median     the median leaf's gap of the same

    The limits file of a cell says which of them it holds to a limit."""
    med = statistics.median(ref["grad"].values())
    moved = {n for n, v in ref["grad"].items() if v >= round_off * med}
    out = {"loss_gap": max(abs(p["total_loss"] - r["total_loss"]) / abs(r["total_loss"])
                           for p, r in zip(prog["losses"], ref["losses"])),
           "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
           "grad_median": median_gap(prog["grad"], ref["grad"]),
           "change1_gap": leaf_gap(prog["change1"], ref["change1"], moved),
           "change1_median": median_gap(prog["change1"], ref["change1"], moved),
           "change_gap": leaf_gap(prog["change"], ref["change"], moved),
           "change_median": median_gap(prog["change"], ref["change"], moved)}
    p, r = prog["losses"][0], ref["losses"][0]
    for k in r:
        out[f"step1.{k}"] = abs(p.get(k, math.nan) - r[k]) / max(abs(r[k]), 1e-12)
    return out


def diagnostics(prog: dict, ref: dict) -> dict:
    """Every loss term's relative gap at each step (for the look at which
    numbers are steady)."""
    return {k: [abs(p.get(k, math.nan) - r[k]) / max(abs(r[k]), 1e-12) for p, r in
                zip(prog["losses"], ref["losses"])] for k in ref["losses"][0]}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], top: int = 4) -> str:
    med = statistics.median(ref.values())
    gaps = sorted(((abs(prog[n] - ref[n]) / max(ref[n], med), n) for n in ref), reverse=True)
    return ", ".join(f"{n} {g:.3g} ({prog[n]:.4g} vs {ref[n]:.4g})" for g, n in gaps[:top]) + \
        f"; median leaf {med:.4g}"


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    return dict(zip(names, torch.stack([torch.linalg.vector_norm(tensors[n].double())
                                        for n in names]).tolist()))


def set_up(cell: common.Cell, seed: int, dev, work: str) -> dict:
    """The dataset, the weights, the trainer loaded with them and its first
    ``check_steps`` steps, with what the reference needs to repeat them."""
    from unit_tpu_torch.data.utils import register_datasets
    from unit_tpu_torch.engine import runner

    mix, config, ref = cell.mix, cell.config, cell.reference
    marks = [("start", time.perf_counter())]
    root = os.path.join(work, "data")
    manifest = traffic.training_data(mix, config, seed, root)
    marks.append(("dataset", time.perf_counter()))
    prog_seed = seed % (2**32 - 16)
    cfg = program_cfg(config, root, prog_seed, os.path.join(work, "out"))
    state = weights.make_state(ref, config, seed, dev)
    marks.append(("weights", time.perf_counter()))
    register_datasets(cfg, root)
    k = int(mix["check_steps"])
    emits = probes.EmitProbe(k).install()
    try:
        model, _, trainer = runner.build_everything(cfg, dev, seed=prog_seed)
        model.load_state_dict(state)
        marks.append(("trainer", time.perf_counter()))
        strong = trainer.strong_iter = probes.FeedProbe(trainer.strong_iter, keep=k)
        weak = trainer.weak_iter = probes.FeedProbe(trainer.weak_iter, keep=k)
        trainer.init_state()
        params = dict(model.named_parameters())
        names = ref.trainable(ref.Recipe(config), state)
        moving = {n for n, p in params.items() if p.requires_grad}
        if moving != set(names):
            common.log(f"[check] the program trains {sorted(moving - set(names))} beyond the "
                       f"reference's and not {sorted(set(names) - moving)}")
        sgd = trainer.optimizer.optimizer

        # the steps the reference repeats: they go through the window's call
        prog = {"losses": [], "grad": None, "change1": None, "change": None}
        for i in range(k):
            m = trainer.run_step()
            prog["losses"].append(dict(m.resolve()))
            if i == 0:
                prog["grad"] = _norms({n: sgd.state.get(params[n], {}).get(
                    "momentum_buffer", torch.zeros_like(params[n])) for n in names})
                prog["change1"] = _norms({n: params[n].detach() - state[n] for n in names})
        prog["change"] = _norms({n: params[n].detach() - state[n] for n in names})
    finally:
        emits.remove()
    marks.append(("first steps", time.perf_counter()))
    common.log("[setup] seconds: " + ", ".join(
        f"{name} {t - marks[i][1]:.2f}" for i, (name, t) in enumerate(marks[1:])))
    return {"cfg": cfg, "state": state, "model": model, "trainer": trainer, "strong": strong,
            "weak": weak, "prog": prog, "prog_seed": prog_seed, "manifest": manifest,
            "ids": emits.ids, "batches": list(zip(strong.kept, weak.kept))}


def reference_batches(cell: common.Cell, s: dict, dev):
    """The kept batches made again from the dataset's files
    (``ref_decode.rebuild``) on ``dev``, and the worst gaps of the loader's
    from them: ``loader.image`` (pixels), ``loader.boxes`` (pixels),
    ``loader.labels`` (classes, flags and labels that differ),
    ``loader.masks`` (mask cells that differ)."""
    ref, config = cell.reference, cell.config
    r = ref.Recipe(config)
    args = dict(manifest=s["manifest"], dataset=config["dataset"], base_ids=set(r.base),
                num_classes=r.c, min_sizes=list(r["INPUT.MIN_SIZE_TRAIN"]),
                max_size=int(r.v.get("INPUT.MAX_SIZE_TRAIN", 1333)),
                max_gt=int(r["TPU.MAX_GT_BOXES"]))
    gaps: Dict[str, float] = {}
    out = []
    for step, pair in enumerate(s["batches"]):
        both = []
        for stream, batch in zip(("strong", "weak"), pair):
            host = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in batch.items()}
            made, g = ref.ref_decode.rebuild(host, s["ids"][stream][step], **args)
            for key, v in g.items():
                gaps["loader." + key] = max(gaps.get("loader." + key, 0.0), v)
            both.append({k: torch.as_tensor(v, device=dev) for k, v in made.items()})
        out.append(tuple(both))
    return out, gaps


def check(cell: common.Cell, s: dict, dev, batches=None, **fault) -> dict:
    """The reference's steps from the same state on its own batches (or
    ``batches``) and the numbers compared (``fault``: a planted fault or
    the control of ``wsod.train``)."""
    t = time.perf_counter()
    if batches is None:
        batches, _ = reference_batches(cell, s, dev)
    ref_out = cell.reference.train(cell.reference.Recipe(cell.config), s["state"], batches,
                                   s["prog_seed"], **fault)
    common.log(f"[check] reference: {len(batches)} steps in {time.perf_counter() - t:.1f} s;"
               f" losses {[round(l['total_loss'], 6) for l in ref_out['losses']]}")
    return ref_out


def run(cell: common.Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    from unit_tpu_torch.utils.profiling import annotate

    mix = cell.mix
    dev = torch.device(device)
    sync = common.synchronizer(dev)
    work = traffic.scratch_dir("train")
    try:
        s = set_up(cell, seed, dev, work)
        cfg, model, trainer = s["cfg"], s["model"], s["trainer"]
        strong, weak, prog = s["strong"], s["weak"], s["prog"]
        k = int(mix["check_steps"])

        # warm-up: every pair of canvas orientations of the two streams
        def pairs():
            return set(zip(strong.shapes, weak.shapes))

        warm = k
        while len(pairs()) < 4 and warm < int(mix["warmup_max_steps"]):
            trainer.run_step()
            warm += 1
        trainer.drain()
        sync()
        common.log(f"[setup] {warm} steps before the window; canvas pairs {sorted(pairs())}")

        # the window
        tracer = Tracer(os.path.join(work, "trace")) if trace else None
        op_probe = probes.OpProbe()
        first = len(strong.waits)
        host: List[float] = []
        traced = (int(mix["trace_skip_steps"]), int(mix["trace_skip_steps"]) + int(mix["traced_steps"]))
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        steps = 0
        path, export_s = None, 0.0
        ann = None
        while time.perf_counter() - t0 < seconds or (trace and steps < traced[1]):
            if trace and steps == traced[0]:
                sync()
                op_probe.install()
                ann = annotate(model)
                ann.__enter__()
                tracer.start()
            t = time.perf_counter()
            if trace and traced[0] <= steps < traced[1]:
                with torch.profiler.record_function(probes.RANGE_PREFIX + "step"):
                    trainer.run_step()
            else:
                trainer.run_step()
            host.append(time.perf_counter() - t)
            steps += 1
            if trace and steps == traced[1]:
                t = time.perf_counter()
                path = tracer.stop()
                export_s = time.perf_counter() - t
                ann.__exit__(None, None, None)
                op_probe.remove()
        trainer.drain()
        sync()
        # a traced run's window leaves out the trace's export
        window_s = time.perf_counter() - t0 - export_s
        images_per_step = int(cfg.SOLVER.IMS_PER_BATCH) * 2
        device = common.device_info(1, dev)
        waits = [a + b for a, b in zip(strong.waits[first:], weak.waits[first:])]
        sizes = [np.concatenate([a, b]) for a, b in zip(strong.sizes[first:], weak.sizes[first:])]
        summary = summarize(path) if path else None
        if path:
            os.remove(path)

        # the reference, once the program's state is freed
        trainer.close()
        del trainer, model, s["trainer"], s["model"]
        gc.collect()
        common.empty_cache(dev)
        batches, gaps = reference_batches(cell, s, dev)
        ref_out = check(cell, s, dev, batches)
        numbers = dict(compare(prog, ref_out, float(mix["round_off"])), **gaps)
        common.log("[check] numbers: " + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items()))
        common.log(f"[check] program losses {[round(l['total_loss'], 6) for l in prog['losses']]}")
        common.log(f"[check] worst gradient leaves: {worst_leaves(prog['grad'], ref_out['grad'])}")
        common.log(f"[check] worst change leaves: {worst_leaves(prog['change'], ref_out['change'])}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    arch = arch_of(cell.config)
    rois = int(cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE) * int(cfg.SOLVER.IMS_PER_BATCH)
    weak_rois = rois // int(cfg.MODEL.ROI_HEADS.WEAK_CLASSIFIER_PROPOSAL_DIVISOR)
    mask_rois = (int(cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE * cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION)
                 * int(cfg.SOLVER.IMS_PER_BATCH))
    step_flops = [cflops.train_step_flops(arch, [tuple(s) for s in sz], rois, weak_rois,
                                          mask_rois) for sz in sizes]
    records = {"steps": steps, "window_s": window_s, "images": steps * images_per_step,
               "data_wait_s": waits, "host_step_s": host, "flops": step_flops,
               "k4_bytes": op_probe.bytes["k4"], "k2_bytes": op_probe.bytes["k2"],
               "traced_steps": traced[1] - traced[0]}
    limits = cell.limits
    checks = {name: {"value": numbers[name], "limit": float(limits[name])} for name in limits}
    result = {"attempted": steps, "failed": 0, "device": device, "checks": checks,
              "records": records, "summary": summary,
              "metrics": {"train_img_s": common.metric(records["images"] / window_s, "images/s"),
                          "setup_s": common.metric(setup_s, "s")}}
    fused = sum(a[1:] == b[1:] for a, b in zip(strong.shapes[first:], weak.shapes[first:]))
    common.log(f"[window] {steps} steps ({fused} with both streams on one canvas), "
               f"{records['images']} images in {window_s:.3f} s: "
               f"{records['images'] / window_s:.4f} images/s; a step's data wait "
               f"{1e3 * sum(waits) / max(len(waits), 1):.3f} ms, host "
               f"{1e3 * sum(host) / max(len(host), 1):.3f} ms; setup {setup_s:.3f} s; peak "
               f"{device['memory_peak_bytes'] / 2**30:.3f} GiB; MFU "
               f"{100 * sum(step_flops) / (window_s * peaks.BF16_FLOPS):.3f}%")
    return result
