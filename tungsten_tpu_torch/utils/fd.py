"""The lanes of a fan of rays on which central finite differences resolve
a medium-level gradient: what chip_smoke.py and the medium-level gradient
tests hold the reattached crossing's d t / d(sigma, l) to.
"""
from __future__ import annotations

import torch


def fd_lanes(run, params, i, eps, device="cpu", n_steps=3):
    """(lanes, each lane's central FD of t1 + t2 + ... at step eps / 4,
    0 off the lanes), both on the CPU, in parameter i of `params`
    (sigma, l); `run(sigma, l)` takes them as float32 tensors on `device`
    and gives the segments' results (dicts with "t" and "exited").

    The lanes are those that hit in every segment at every evaluation
    (the caller's own evaluation at `params` is not repeated here), whose
    t's have central differences at the `n_steps` steps eps,
    eps / 4 (and eps / 16) each within 10% (+ 0.05) of the next, segment
    by segment, and whose summed t moves at each step.  A lane whose march
    takes another bracket or refinement path across the stencil jumps in
    t, which FD turns into a slope no derivative has, and at two steps
    alone such a lane can agree with itself by chance; a lane whose t
    does not move at all (a search that stops at a fixed point off the
    root) agrees with itself at 0, which no derivative taken at the root
    need be."""
    def at(d):
        x = list(params)
        x[i] += d
        with torch.no_grad():
            res = run(*(torch.tensor(v, dtype=torch.float32, device=device)
                        for v in x))
        hit = torch.ones_like(res[0]["exited"])
        for r in res:
            hit &= ~r["exited"]
        return [r["t"].cpu() for r in res], hit.cpu()

    steps = tuple(eps / 4 ** k for k in range(n_steps))
    evals = {d: at(d) for h in steps for d in (h, -h)}
    lanes = torch.ones_like(evals[eps][1])
    for _, hit in evals.values():
        lanes &= hit
    for k in range(len(evals[eps][0])):
        fds = [(evals[h][0][k] - evals[-h][0][k]) / (2 * h) for h in steps]
        for a, b in zip(fds, fds[1:]):
            lanes &= (a - b).abs() <= 0.1 * a.abs() + 0.05
    for h in steps:
        lanes &= sum(evals[h][0]) != sum(evals[-h][0])
    h = steps[1]
    fd = (sum(evals[h][0]) - sum(evals[-h][0])) / (2 * h)
    return lanes, torch.where(lanes, fd, 0.0)
