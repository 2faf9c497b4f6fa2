"""train_mfu: the model operations of every step of the window
(counts.flops, at each image's own resized size and the sampled ROI
counts, no recompute) over the window's time at 989 TFLOP/s (dense bf16),
in %.  Layer: device, the whole step.  Harness clock and counts."""

from counts import peaks


def read(run):
    rec = run["records"]
    if not rec.get("flops") or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * sum(rec["flops"]) / (rec["window_s"] * peaks.BF16_FLOPS)
