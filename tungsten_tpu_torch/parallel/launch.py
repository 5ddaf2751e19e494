"""Start `world` ranks of one process group on this machine and collect
what each returns: `spawn(job, world, *args, backend="gloo")`.

Each rank is a fresh process (the `spawn` start method: CUDA and threads
do not survive a fork) that joins the group at `tcp://127.0.0.1:<a free
port>` with `LOCAL_RANK` set to its rank (an nccl rank also takes that
card as its current device), runs `job(rank, world, *args)` and hands its
result back through a file in a temporary directory.  `job` is pickled by its import path, so it
must be a module-level function of this package: a child then imports the
port alone, never a test module or JAX.  The CUDA libraries a job uses are
to be built before the ranks start (`kernels/*.build()`); `kernels/nvcc.py`
also serialises concurrent builds of one library with a file lock.
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port():
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, job, world, backend, port, out_dir, threads, args):
    # every rank runs on this machine: its local rank is its rank
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        result = job(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(job, world, *args, backend="gloo", threads=0):
    """[job(rank, world, *args) for each rank], each run in its own
    process of a `backend` group of `world` ranks (`threads`: each rank's
    torch.set_num_threads, 0 to keep torch's default).  A rank that
    raises makes this raise torch.multiprocessing's ProcessRaisedException
    with its traceback."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(job, world, backend, free_port(), out_dir,
                                 threads, args))
        results = []
        for rank in range(world):
            # written by this call's own ranks, in this call's directory
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
