"""backbone_ms.train: device ms a traced step under the program's
``unit:backbone`` range (utils/profiling.annotate), forward and backward.
Layer: model (models/resnet.py, meta_arch.py).  Device trace."""


def read(run):
    s = run.get("summary")
    if not s or not s["steps"]:
        return None
    r = s["ranges"]
    ms = 1e3 * (r.get("backbone fwd", 0.0) + r.get("backbone bwd", 0.0))
    return ms / s["steps"] if ms > 0 else None
