"""host_step_ms.train: host ms of a ``run_step()`` call, what the host holds
before the call returns (the step's data wait, its eager ops and launches),
the mean over the window's steps.  Layer: trainer (engine/train.py).
Harness clock."""


def read(run):
    host = run["records"].get("host_step_s")
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
