"""The buffers of a kernel that sums its partials over points inside its
launch (K1b, K3b; csrc/grid_sum.cuh): a float64 scratch of one row per
block, and a ticket, one device word that each launch leaves at 0.

Launches that share a ticket must not overlap, so there is one ticket per
(device, stream): launches on one stream run in order, and launches on two
streams take two tickets.  A ticket is made (zeroed) on its stream at its
first use and kept.
"""
from __future__ import annotations

import ctypes

import torch

_TICKETS = {}  # (device index, stream handle) -> int32 [1] at 0


def buffers(grid, n, impulse_count, device, parts, name):
    """(blocks, scratch [blocks, parts] float64, ticket, stream handle) for
    one launch of `name` on n points on the current stream of `device` (a
    CUDA torch.device); grid(n, impulse_count, device index, byref(int))
    is the kernel's grid query."""
    blocks = ctypes.c_int(0)
    err = grid(n, int(impulse_count), device.index, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name}'s grid query failed: CUDA error {err}")
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    scratch = torch.empty(blocks.value, parts, dtype=torch.float64,
                          device=device)
    return blocks.value, scratch, _TICKETS[key], stream
