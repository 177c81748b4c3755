"""A world of ranks on this host, as spawned processes serving calls.

The JAX package drives every device of a mesh from one process; the port
runs one process per rank. `LocalWorld` spawns those processes once, joins
them into one gloo process group over localhost TCP and then runs
module-level functions on every rank: `world.run(fn, *args)` calls
fn(*args) on each rank and returns their results in rank order. A rank
that raises, dies or outlives the call's timeout fails the call; the
world is then closed. Used by the tests (4 ranks on the CPU) and by
chip_smoke.py (4 ranks sharing one card, which holds one NCCL rank at
most). Ranks with a card each are launched by a launcher such as
torchrun and join through initialize_distributed (NCCL).

Each rank gets RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
in its environment, as a torch launcher would set them, and joins the
group through parallel.mesh.initialize_distributed.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank: int, size: int, port: int, threads: int, calls, results) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        import torch

        from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

        torch.set_num_threads(threads)
        mesh_lib.initialize_distributed(backend="gloo")
        results.put((rank, "ready", None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        call = calls.get()
        if call is None:
            break
        fn, args, kwargs = call
        try:
            results.put((rank, "ok", fn(*args, **kwargs)))
        except BaseException:  # noqa: BLE001 — reported to the parent
            results.put((rank, "error", traceback.format_exc()))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class WorldError(RuntimeError):
    """A rank failed, died or timed out."""


class LocalWorld:
    """`size` ranks as spawned processes in one gloo process group, each
    with `threads` torch threads; `timeout_s` bounds their start."""

    def __init__(self, size: int, threads: int = 1, timeout_s: float = 120.0):
        context = multiprocessing.get_context("spawn")
        self.size = size
        self._results = context.Queue()
        self._calls = [context.Queue() for _ in range(size)]
        port = free_port()
        self._procs = [
            context.Process(
                target=_serve,
                args=(rank, size, port, threads, self._calls[rank], self._results),
                daemon=True,
            )
            for rank in range(size)
        ]
        for proc in self._procs:
            proc.start()
        try:
            self._collect(timeout_s, "start")
        except BaseException:
            self.close()
            raise

    def _collect(self, timeout_s: float, what: str) -> List[Any]:
        out: List[Any] = [None] * self.size
        pending = set(range(self.size))
        deadline = time.monotonic() + timeout_s
        while pending:
            try:
                rank, status, value = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r in pending if self._procs[r].exitcode is not None]
                if dead:
                    raise WorldError(
                        f"{what}: rank(s) {dead} exited with "
                        f"{[self._procs[r].exitcode for r in dead]}")
                if time.monotonic() > deadline:
                    raise WorldError(
                        f"{what}: rank(s) {sorted(pending)} still running after "
                        f"{timeout_s:.0f}s")
                continue
            if status == "error":
                raise WorldError(f"{what}: rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        return out

    def run(self, fn: Callable, *args, timeout_s: float = 600.0, **kwargs) -> List[Any]:
        """fn(*args, **kwargs) on every rank; the results in rank order.
        fn must be importable by its module and name (a spawned rank
        unpickles it). Any failure closes the world and raises."""
        for calls in self._calls:
            calls.put((fn, args, kwargs))
        try:
            return self._collect(timeout_s, getattr(fn, "__name__", str(fn)))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stops every rank (politely, then by force), draining the results
        queue meanwhile so no rank blocks on a result nobody reads."""
        for calls, proc in zip(self._calls, self._procs):
            if proc.is_alive():
                calls.put(None)
        deadline = time.monotonic() + 10
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            try:
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
            proc.join()

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
