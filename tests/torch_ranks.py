"""Data-parallel ranks for the port's tests: processes on the CPU that join
a gloo group through `rrnet_torch.parallel.init_from_env`, as `torchrun`
would start them.

`start(code, world, log_dir)` runs `python -c code` once a rank with
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set (the port
from binding port 0), two threads a rank; `wait(procs, timeout)` waits
for every rank with a deadline, kills them all on a timeout or as soon as
one fails (so a hung rendezvous fails one test instead of stalling the
run), and returns their outputs. A rank's code calls `join()` first: the
group with a 60 s timeout.
"""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join():
    """In a rank: two threads, and the gloo group from the environment."""
    import torch
    from rrnet_torch.parallel import init_from_env
    torch.set_num_threads(2)
    return init_from_env("cpu", timeout_s=60)


def start(code, world, log_dir):
    port = str(free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=port, OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.path.join(REPO, "tests"),
                        os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(str(log_dir), f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            cwd=str(log_dir), stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait(procs, timeout):
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = any(p.poll() not in (None, 0) for p, _ in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        for p, log in procs:
            p.communicate(timeout=30)
            log.close()
    outs = [open(log.name).read() for _, log in procs]
    for rank, ((p, _), out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {rank} exited with {p.returncode} (timeout {timeout} s):"
            f"\n{out[-6000:]}")
    return outs
