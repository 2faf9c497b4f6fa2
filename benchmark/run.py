"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``unit_tpu_torch``).
The cell, its configuration, its traffic mix, its limits, its reference
and the readers of its per-layer metrics are found by the names in
BENCHMARK.json.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the reference beside its limit, which are also the last lines of standard
error.  Without a card, or with fewer than the cell asks for, or with JAX
or the JAX package loaded at the end, it prints no result and exits 2."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "reference"), ROOT):
    if p not in sys.path:
        sys.path.insert(1, p)
# every build and kernel cache of the run at a fixed place inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
# one process with few threads: the run is paced by the host (PERF.md), and
# an intra-op pool as wide as the card's host adds to the jitter of a step
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_result(cell, out: dict, trace: bool) -> dict:
    """The result line of a cell's run: ``checks`` last."""
    from harness import common

    correct = common.judge(out["checks"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        run = {"records": out["records"], "summary": out["summary"]}
        result["metrics"] = common.read_layers(cell, run)
        s = out["summary"]
        result["device"] = dict(out["device"], busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    else:
        result["metrics"] = {m["name"]: out["metrics"][m["name"]] for m in cell.end_to_end}
        result["device"] = out["device"]
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in out["checks"].items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from harness import common

    spec = common.load_json(ROOT, "BENCHMARK.json")
    cell = common.Cell(spec, args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"no result: the cell needs {chips} CUDA device(s); "
                   f"available {torch.cuda.is_available()}, "
                   f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    common.log(f"[card] {common.power_limit()}; torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}")
    kind = cell.mix["kind"]
    if kind != "train":
        raise SystemExit(f"unknown traffic kind {kind!r}")
    from harness import train as cell_kind
    out = cell_kind.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = common.forbidden_modules()
    if found:
        common.log(f"no result: {found} loaded in the process that measured")
        return 2
    result = make_result(cell, out, bool(args.trace))
    common.log("[result] " + " ".join(f"{k} {v['value']:.6g} {v['unit']}"
                                      for k, v in result["metrics"].items()))
    common.log(f"correct {result['correct']}; the numbers compared, each beside its limit:")
    for k, v in out["checks"].items():
        common.log(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
