"""Starting the ranks of a data-parallel run: one process a rank.

The counterpart of unit_tpu's mesh set-up (the DP half of
unit_tpu/parallel/mesh.py) and of ``jax.distributed.initialize()``
(unit_tpu/engine/runner.py:515).  Where unit_tpu jits one program over a
device mesh, the port runs one process a device, each with its own copy of
the parameters; the train step all-reduces the gradients
(``comm.all_reduce_mean_tensors``), so every rank takes the step of the
global batch.

  * ``launch(main, world, devices, ...)`` spawns ``world`` processes; rank r
    joins the group on ``devices[r]`` and calls ``main(device, *args)``.
    The caller names the devices and the backend: NCCL for cards by
    default, gloo for the CPU.  Ranks may share a card only over gloo, and
    only when the caller passes such a list; nothing falls back from NCCL
    to gloo on its own.
  * ``init_from_env()`` joins the group torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): the
    ``--dist`` path.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

Device = Union[int, str, torch.device]


def _device(spec: Device) -> torch.device:
    """A rank's device from its entry in ``devices``: an int is a card's index."""
    return torch.device("cuda", spec) if isinstance(spec, int) else torch.device(spec)


def _check_devices(devices: Sequence[torch.device], backend: str) -> None:
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"the ranks' devices must be all cards or all cpu: {devices}")
    if "cpu" in kinds:
        if backend != "gloo":
            raise ValueError(f"ranks on the CPU need the gloo backend, not {backend!r}")
        return
    count = torch.cuda.device_count()
    indices = [d.index for d in devices]
    if any(i is None or not 0 <= i < count for i in indices):
        raise ValueError(f"cards {indices} asked for, {count} present")
    if backend == "nccl" and len(set(indices)) < len(indices):
        raise ValueError(f"NCCL refuses two ranks on one card ({indices}); pass "
                         "backend='gloo' to share a card on purpose")


def _bind(device: torch.device, cpu_threads: int) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(cpu_threads)


def _timeout(seconds: Optional[float]):
    return {} if seconds is None else {"timeout": datetime.timedelta(seconds=seconds)}


def _worker(rank: int, main: Callable, world: int, devices: List[torch.device], backend: str,
            init_method: str, timeout: Optional[float], cpu_threads: int, args: tuple,
            results) -> None:
    faulthandler.enable()  # a rank that dies in C prints where
    try:
        device = devices[rank]
        _bind(device, cpu_threads)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **_timeout(timeout))
        try:
            # pickled while the group stands: a trainer's losses in flight
            # (engine.train.LazyMetrics) resolve through an all-reduce
            out = pickle.dumps(main(device, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def launch(main: Callable, world: int, devices: Sequence[Device], backend: Optional[str] = None,
           init_method: Optional[str] = None, args: tuple = (),
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``main(device, *args)`` in ``world`` spawned processes, rank r on
    ``devices[r]`` (an int names a card, ``"cpu"`` the CPU), and return
    their results in rank order.

    ``main`` and ``args`` are pickled (``main`` by its import path).
    ``backend``: "nccl" for cards, "gloo" for the CPU by default.
    ``init_method``: the rendezvous, by default a file in a fresh temporary
    directory (no port to pick).  ``timeout`` (seconds) bounds the group's
    set-up and collectives and the whole run: past it every rank is killed
    and ``TimeoutError`` raised.  A rank that raises, or dies, fails the
    launch: the others are killed and its traceback raised.  CPU ranks
    share this process's torch threads."""
    devs = [_device(d) for d in devices]
    if len(devs) != world or world < 1:
        raise ValueError(f"{world} ranks need {world} devices, got {list(devices)}")
    backend = backend or ("nccl" if devs[0].type == "cuda" else "gloo")
    _check_devices(devs, backend)
    rendezvous = None
    if init_method is None:
        rendezvous = tempfile.mkdtemp(prefix="unit_tpu_torch_rdzv_")
        init_method = "file://" + os.path.join(rendezvous, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    cpu_threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_worker, name=f"rank{r}",
                         args=(r, main, world, devs, backend, init_method, timeout,
                               cpu_threads, tuple(args), results))
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                _check_alive(procs, out, results)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {world} ranks did not finish in {timeout} s; "
                                       f"done: {sorted(out)}") from None
                continue
            if not ok:
                _raise_failures(world, [(r, value)], results)
            out[r] = pickle.loads(value)
    finally:
        for p in procs:
            if p.pid is None:
                continue
            p.join(timeout=5.0 if len(out) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if rendezvous is not None:
            shutil.rmtree(rendezvous, ignore_errors=True)
    return [out[r] for r in range(world)]


def _raise_failures(world: int, failures, results, grace: float = 3.0):
    """Raise every failure that arrives within ``grace`` seconds of the first:
    the rank whose error broke the group may report after a peer whose
    collective broke with it."""
    deadline = time.monotonic() + grace
    while len(failures) < world and time.monotonic() < deadline:
        try:
            r, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            failures.append((r, value))
    raise RuntimeError("\n".join(f"rank {r} of {world} failed:\n{value}"
                                  for r, value in failures))


def _check_alive(procs, out, results) -> None:
    """Raise if a rank exited without a result (killed, or died in C)."""
    for r, p in enumerate(procs):
        if r not in out and p.exitcode is not None:
            try:  # its result may have been queued just before it exited
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no "
                                   "result") from None
            if not ok:
                _raise_failures(len(procs), [(rank, value)], results)
            out[rank] = pickle.loads(value)


def init_from_env(device_type: str = "cuda") -> torch.device:
    """Join the process group that torchrun describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: card ``LOCAL_RANK`` over
    NCCL, or the CPU over gloo for ``device_type="cpu"``."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--dist needs torchrun's environment; missing {missing}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    backend = "nccl" if device.type == "cuda" else "gloo"
    _check_devices([device], backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return device
