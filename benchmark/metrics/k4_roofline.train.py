"""k4_roofline.train: the least time the FrozenBN + residual + ReLU epilogue
could take for its own inputs and outputs (counts.bytes: x, residual and
output forward; gradient, saved output and input gradients backward) at the
HBM rate, over the device time of whatever runs inside the op's range
(``unit:k4``, forward and backward), summed over the traced steps, in %.
Layer: kernels (ops/bn_act.py, csrc/bn_act.cu).  Device trace."""

from counts import peaks


def read(run):
    s = run.get("summary")
    if not s:
        return None
    t = s["ranges"].get("k4 fwd", 0.0) + s["ranges"].get("k4 bwd", 0.0)
    moved = run["records"].get("k4_bytes", 0)
    if t <= 0 or moved <= 0:
        return None
    return 100.0 * (moved / peaks.HBM_BYTES_PER_S) / t
