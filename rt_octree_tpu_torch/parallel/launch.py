"""Start ``world`` rank processes, rendezvous them and collect what each
returns.

``launch(fn, world, backend=..., device=...)`` spawns one process a rank
(``torch.multiprocessing.start_processes``, start method "spawn"), which
joins a process group over a ``file://`` store in a fresh temporary
directory (no TCP port, so concurrent launches never collide) with a
60-second collective timeout, calls ``fn(device, *args)`` and saves its
return value; the caller gets the ranks' values in rank order, their
tensors on the CPU.  A rank that raises makes ``launch`` terminate every
rank and raise RuntimeError with the traceback of each rank that failed;
the deadline stops them all with TimeoutError.

The backend and the device are the caller's choice, never switched on
their own: ``"nccl"`` needs one distinct card a rank; ``"gloo"`` serves
CPU ranks and several ranks on one card.  Rank r runs on
``cuda:(r % device_count)`` unless ``device="cpu"``; CPU ranks take one
thread each.

The spawned process imports the module that defines ``fn`` (and the
caller's main script, as ``__mp_main__``), so ``fn`` lives at the top of
an importable module whose imports the ranks can pay for.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
PG_TIMEOUT_S = 60.0


def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               root: str, args: tuple, pg_timeout_s: float) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(root, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=pg_timeout_s))
    try:
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, *, backend: str, device: str = "cuda",
           args: tuple = (), timeout_s: float = 600.0,
           pg_timeout_s: float = PG_TIMEOUT_S) -> list:
    """Run ``fn(device, *args)`` in ``world`` rank processes of one process
    group and return their values, rank by rank (tensors mapped to the
    CPU).  Raises ValueError for a backend or device that cannot serve
    ``world`` ranks, RuntimeError with the traceback of every rank that
    failed if a rank raises, and TimeoutError when the ranks are not done
    ``timeout_s`` seconds after the start; every rank is stopped first."""
    if backend not in BACKENDS:
        raise ValueError(f"launch: backend {backend!r} is not one of "
                         f"{BACKENDS}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"launch: device {device!r} is not 'cuda' or 'cpu'")
    if world < 1:
        raise ValueError(f"launch: world {world}")
    if device == "cuda" and not torch.cuda.is_available():
        raise ValueError("launch: device 'cuda' but no CUDA device is "
                         "visible")
    if backend == "nccl" and (device != "cuda"
                              or world > torch.cuda.device_count()):
        raise ValueError(
            f"launch: nccl needs one distinct card a rank; {world} ranks on "
            f"{torch.cuda.device_count() if device == 'cuda' else 0} cards "
            "(use gloo for several ranks on one card or for CPU ranks)")
    root = tempfile.mkdtemp(prefix="rt_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, device, root, tuple(args),
                              pg_timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"launch: {world} ranks not done "
                                       f"within {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # join() has stopped the other ranks: their error files are
            # complete
            raise RuntimeError(_rank_errors(ctx, world) or str(e)) from e
        finally:
            _stop(ctx.processes)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _rank_errors(ctx, world: int) -> str:
    """Every failed rank's traceback, rank by rank: the first failure and
    the collectives it broke in the other ranks."""
    msgs = []
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as fh:
                msgs.append(f"-- rank {r} of {world}:\n{pickle.load(fh)}")
    return "\n".join(msgs)


def _stop(procs) -> None:
    """Terminate every rank process still alive, then kill what remains."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()
