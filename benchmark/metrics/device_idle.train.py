"""device_idle.train: the share of the traced window in which no device
event ran (1 - the union of the device intervals over the window), in %.
Layer: device.  Device trace."""


def read(run):
    s = run.get("summary")
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
