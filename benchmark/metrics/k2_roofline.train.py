"""k2_roofline.train: the least time ROIAlign's backward could take for the
incoming gradient read and the map gradient written (counts.bytes) at the
HBM rate, over the device time of the backward of whatever runs inside the
op's range (``unit:roi_align``), summed over the traced steps, in %.
Layer: kernels (ops/roi_align.py, csrc/roi_align_bwd.cu).  Device trace."""

from counts import peaks


def read(run):
    s = run.get("summary")
    if not s:
        return None
    t = s["ranges"].get("roi_align bwd", 0.0)
    moved = run["records"].get("k2_bytes", 0)
    if t <= 0 or moved <= 0:
        return None
    return 100.0 * (moved / peaks.HBM_BYTES_PER_S) / t
