"""data_wait_ms.train: host ms a step the trainer waits in ``next()`` on the
port's loader streams (strong + weak), the mean over the window's steps.
Layer: loader (data/loader.py, data/native.py).  Harness clock."""


def read(run):
    waits = run["records"].get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
