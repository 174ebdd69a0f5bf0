"""Gloo ranks for the port's multi-process tests.

``run_ranks(suite, world, workdir)`` starts ``world`` fresh interpreters of
``tests/_torch_dist_worker.py``, joined by ``torch.distributed`` on gloo
over a free localhost port, each with one thread. They import torch and the
port only. Every rank runs every case of ``suite`` on the inputs the test
wrote to ``workdir/inputs.npz`` and saves its results to
``workdir/out_rank{r}.npz``; the test process then holds them against JAX.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from tests._threads import single_thread_env

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("_torch_dist_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(suite: str, world: int, workdir: Path, timeout: float = 240.0) -> list:
    """Run ``suite`` on ``world`` gloo ranks; returns each rank's results
    (a dict of arrays). Fails with the ranks' logs when a rank fails or
    the run outlasts ``timeout`` seconds (every rank is then killed)."""
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(world):
            env = single_thread_env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                                    MASTER_ADDR="localhost", MASTER_PORT=str(port),
                                    PYTHONPATH=str(REPO))
            log = open(workdir / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, str(WORKER), suite, str(workdir)],
                                          env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:] for r in failed)
        raise AssertionError(f"{suite}: ranks {failed} failed\n{tails}")
    return [dict(np.load(workdir / f"out_rank{r}.npz")) for r in range(world)]
