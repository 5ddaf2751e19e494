"""Per-pipe instruction counts of a built kernel, read from its SASS.

`cuobjdump -sass` lists the machine instructions of each kernel in a
library.  This module parses such a listing into basic blocks and loops,
and counts the instructions along given paths by the pipe of Hopper's SM
that executes them, so that a kernel's lower bound rests on what the
compiler emitted rather than on operations read off the source:

- "issue": every instruction; each of an SM's 4 schedulers issues one warp
  instruction per clock, 128 thread-instructions per SM and clock;
- "fma": FP32 adds, multiplies and FMAs and integer multiply-adds (IMAD,
  IMUL), which share the FMA pipes, 128 lanes;
- "fmaheavy": the integer multiply-adds alone, which only the heavy FMA
  pipe runs, 64 lanes;
- "alu": integer adds, logic, shifts, compares, min/max and selects, 64
  lanes;
- "xu": MUFU (reciprocal, exp2, ...), conversions other than I2FP, FRND,
  population count, 16 lanes.

Rates per SM and clock are those of NVIDIA's CUDA C++ Programming Guide
(arithmetic instruction throughput, compute capability 9.0); the split of
integer multiply-adds onto the FMA pipe is Nsight Compute's pipeline
description.  An instruction whose pipe is not certain (MOV, VIADD,
HFMA2.MMA, loads, shuffles, uniform-datapath instructions) counts towards
"issue" only, so each class's count is at most what the pipe executes and
the bound built on it is a lower bound.

The lattice kernels K1, K2, K2b and K3b branch around each impulse's
last variate and its expf when the impulse lies beyond the splat (d^2 >=
1): `lattice_counts` counts the short path for every impulse and the long
path's extra instructions for the expected number of impulses within
reach.  K1b splits its walk into a test loop that appends the impulses
within reach to a ring in shared memory and a drain loop that works them
off: `split_counts` counts the test loop's short path for every
iteration, the append and one drained entry for each expected impulse
within reach, and the loops around them.  K8's Jacobi rounds rotate A's 2x2
blocks and V's (row, pair) units in guarded, unrolled bodies inside the
round loop: `jacobi_counts` counts one body of each.  The listing comes
from `nvcc.sass_listing`.
"""
from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

SM_RATES = {"issue": 128, "fma": 128, "fmaheavy": 64, "alu": 64, "xu": 16}
CLASSES = tuple(SM_RATES)

_FMA = {"FADD", "FMUL", "FFMA", "FSWZADD"}
_IMAD = {"IMAD", "IMUL", "IDP"}
_ALU = {"IADD3", "LOP3", "SHF", "ISETP", "FSETP", "FMNMX", "IMNMX", "SEL",
        "FSEL", "LEA", "PRMT", "PLOP3", "IABS", "BMSK", "SGXT"}
_XU = {"MUFU", "F2I", "I2F", "FRND", "POPC", "FLO", "BREV", "F2F"}

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)([^;]*);")
_HEX = re.compile(r"0x([0-9a-f]+)")


def pipes(op):
    """The classes an instruction (its opcode with modifiers) counts in."""
    base = op.split(".")[0]
    if base == "NOP":
        return ()
    if base in _FMA:
        return ("issue", "fma")
    if base in _IMAD:
        return ("issue", "fma", "fmaheavy")
    if base in _ALU:
        return ("issue", "alu")
    if base in _XU:
        return ("issue", "xu")
    return ("issue",)


@dataclass
class Instr:
    addr: int
    pred: str
    op: str
    args: str


@dataclass
class Block:
    start: int  # address of the first instruction
    instrs: list
    succ: list = field(default_factory=list)

    def count(self, cls):
        return sum(cls in pipes(i.op) for i in self.instrs)

    def has(self, op):
        return any(i.op.startswith(op) for i in self.instrs)


def parse(text):
    """{kernel name: [Instr]} of a cuobjdump -sass listing."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append(Instr(int(m.group(1), 16), (m.group(2) or "").strip(),
                             m.group(3), m.group(4)))
    return out


class Cfg:
    """Basic blocks, reachable from the entry, and natural loops of one
    kernel's instructions.  Calls into subroutines are not followed (their
    instructions count nowhere, which only lowers a bound)."""

    def __init__(self, instrs):
        index = {ins.addr: k for k, ins in enumerate(instrs)}
        leaders = {0}
        for k, ins in enumerate(instrs):
            base = ins.op.split(".")[0]
            if base in ("BRX", "JMP", "JMX"):
                raise ValueError(f"indirect branch at {ins.addr:#x}")
            if base in ("BRA", "EXIT", "RET", "CALL"):
                if k + 1 < len(instrs):
                    leaders.add(k + 1)
                if base in ("BRA", "CALL"):
                    target = int(_HEX.findall(ins.args)[-1], 16)
                    leaders.add(index[target])
        starts = sorted(leaders)
        blocks = {}
        for a, b in zip(starts, starts[1:] + [len(instrs)]):
            blocks[instrs[a].addr] = Block(instrs[a].addr, instrs[a:b])
        order = sorted(blocks)
        for k, s in enumerate(order):
            blk = blocks[s]
            last = blk.instrs[-1]
            base = last.op.split(".")[0]
            nxt = order[k + 1] if k + 1 < len(order) else None
            conditional = bool(last.pred) or ".DIV" in last.op
            if base == "BRA":
                target = int(_HEX.findall(last.args)[-1], 16)
                blk.succ = [target] + ([nxt] if conditional and nxt else [])
            elif base in ("EXIT", "RET"):
                blk.succ = [nxt] if conditional and nxt is not None else []
            elif nxt is not None:
                blk.succ = [nxt]
        seen, todo = set(), [order[0]]
        while todo:
            s = todo.pop()
            if s not in seen:
                seen.add(s)
                todo.extend(blocks[s].succ)
        self.blocks = {s: b for s, b in blocks.items() if s in seen}
        self.loops = self._loops()

    def _loops(self):
        """{header: (body, latches)} of the natural loops."""
        pred = {s: [] for s in self.blocks}
        for s, b in self.blocks.items():
            for t in b.succ:
                pred[t].append(s)
        loops = {}
        for s, b in self.blocks.items():
            for h in b.succ:
                if h <= s:  # a back edge s -> h
                    body, latches = loops.setdefault(h, ({h}, set()))
                    latches.add(s)
                    todo = [s]
                    while todo:
                        x = todo.pop()
                        if x not in body:
                            body.add(x)
                            todo.extend(pred[x])
        return loops

    def parent(self, header):
        """Header of the smallest loop that strictly contains this one."""
        body = self.loops[header][0]
        outer = [h for h, (b, _) in self.loops.items()
                 if h != header and body < b]
        return min(outer, key=lambda h: len(self.loops[h][0]), default=None)

    def innermost(self, op):
        """Headers of the loops holding a block with `op` and no inner loop
        that holds one."""
        hits = [h for h, (b, _) in self.loops.items()
                if any(self.blocks[s].has(op) for s in b)]
        return [h for h in hits
                if not any(g != h and self.loops[g][0] < self.loops[h][0]
                           for g in hits)]

    def path(self, src, dst, nodes, cls):
        """Fewest `cls` instructions on a path src -> dst within `nodes`,
        both ends counted."""
        best = {src: self.blocks[src].count(cls)}
        heap = [(best[src], src)]
        while heap:
            d, x = heapq.heappop(heap)
            if x == dst:
                return d
            if d > best[x]:
                continue
            for t in self.blocks[x].succ:
                if t in nodes and t != src:
                    nd = d + self.blocks[t].count(cls)
                    if nd < best.get(t, float("inf")):
                        best[t] = nd
                        heapq.heappush(heap, (nd, t))
        raise ValueError(f"no path {src:#x} -> {dst:#x}")


def _loop_iteration(cfg, header, cls, via=None):
    """Fewest `cls` instructions of one iteration of the loop at `header`
    (header to a latch), through the block `via` when given."""
    body, latches = cfg.loops[header]
    best = float("inf")
    for latch in latches:
        if via is None:
            n = cfg.path(header, latch, body, cls)
        else:
            n = (cfg.path(header, via, body, cls)
                 + cfg.path(via, latch, body, cls)
                 - cfg.blocks[via].count(cls))
        best = min(best, n)
    return best


def _around(cfg, outer, inner, cls):
    """Fewest `cls` instructions of one iteration of the loop at `outer`
    outside the loop at `inner` that it holds: from its header into
    `inner`, and from an exit of `inner` back to a latch of `outer`."""
    body, latches = cfg.loops[inner]
    pbody, platches = cfg.loops[outer]
    outside = (pbody - body) | {inner}
    exits = {t for s in latches for t in cfg.blocks[s].succ if t not in body}
    into = cfg.path(outer, inner, outside, cls) - cfg.blocks[inner].count(cls)
    after = min(cfg.path(e, lt, pbody - body, cls)
                for e in exits for lt in platches)
    return into + after


def _kernel_cfg(text, kernel):
    fns = {k: v for k, v in parse(text).items() if kernel in k}
    if len(fns) != 1:
        raise ValueError(f"{len(fns)} kernels match {kernel!r}")
    return Cfg(next(iter(fns.values())))


def lattice_counts(text, kernel, iters, long_hits, cells=0):
    """Per-class instructions per point of a lattice-sum kernel: the
    innermost loop holding MUFU.EX2 (K1/K2: one impulse an iteration; K3:
    the whole point) run `iters` times on its short path, plus the fewest
    extra instructions of one long path (through a MUFU.EX2 block) for each
    of `long_hits` expected impulses within reach; with `cells`, plus
    `cells` times the enclosing loop's own instructions around it (K1/K2's
    cell hash).  `kernel` is a substring of the kernel's mangled name."""
    cfg = _kernel_cfg(text, kernel)
    inner = cfg.innermost("MUFU.EX2")
    if len(inner) != 1:
        raise ValueError(f"{kernel}: {len(inner)} innermost expf loops")
    h = inner[0]
    body = cfg.loops[h][0]
    ex2 = [s for s in body if cfg.blocks[s].has("MUFU.EX2")]
    out = {}
    for cls in CLASSES:
        short = _loop_iteration(cfg, h, cls)
        extra = min(_loop_iteration(cfg, h, cls, via=s) for s in ex2) - short
        n = iters * short + long_hits * extra
        if cells:
            p = cfg.parent(h)
            if p is None:
                raise ValueError(f"{kernel}: the impulse loop has no cell "
                                 "loop around it")
            n += cells * _around(cfg, p, h, cls)
        out[cls] = n
    return out


def split_counts(text, kernel, iters, hits, around=0):
    """Per-class instructions per point of a kernel whose walk tests each
    impulse and drains the ones within reach from a ring (K1b).

    The drain loops are the innermost loops holding MUFU.EX2 (one inside
    the walk, one after it); the test loop is the smallest loop around
    one of them (K = 3 unrolled: the cell loop).  Counted: `iters` times
    the test loop's short path (outside the drain loops, no append),
    `hits` times the extra of an append (a path through a block of the
    test loop holding STS, if any) and of one drained entry (an
    iteration through a MUFU.EX2 block), and with `around`, that many
    times the enclosing loop's own instructions around the test loop
    (K1b's point loop: its loads, epilogue and float64 partials)."""
    cfg = _kernel_cfg(text, kernel)
    drains = cfg.innermost("MUFU.EX2")
    parents = {cfg.parent(d) for d in drains} - {None}
    if not parents:
        raise ValueError(f"{kernel}: no drain loop inside a test loop")
    test = min(parents, key=lambda h: len(cfg.loops[h][0]))
    drained = set().union(*(cfg.loops[d][0] for d in drains))
    body, latches = cfg.loops[test]
    nodes = body - drained
    stores = [s for s in nodes if cfg.blocks[s].has("STS")]
    outer = cfg.parent(test)
    if around and outer is None:
        raise ValueError(f"{kernel}: the test loop has no loop around it")
    out = {}
    for cls in CLASSES:
        short = min(cfg.path(test, lt, nodes, cls) for lt in latches)
        append = min((cfg.path(test, s, nodes, cls)
                      + min(cfg.path(s, lt, nodes, cls) for lt in latches)
                      - cfg.blocks[s].count(cls) for s in stores),
                     default=short) - short
        entry = min(_loop_iteration(cfg, d, cls, via=s) for d in drains
                    for s in cfg.loops[d][0]
                    if cfg.blocks[s].has("MUFU.EX2"))
        n = iters * short + hits * (append + entry)
        if around:
            n += around * _around(cfg, outer, test, cls)
        out[cls] = n
    return out


def jacobi_counts(text, kernel):
    """Per-class instructions of one A block and of one V unit of K8's
    round, from its SASS.  The round loop is the innermost loop that holds
    a barrier (BAR), a float64 multiply (DMUL) and a shared-memory store
    (STS), without device memory (LDG, STG).  In it, an A block's body is
    a basic block that loads, multiplies in float32 (FMUL) and stores to
    shared memory without float64 work; a V unit's body one that loads,
    multiplies in float64 (DMUL) and stores, without MUFU or F2F (those
    are the rotation's own step).  Returns (A block, V unit): each the
    per-class counts of one body, the one of each kind that issues the
    fewest instructions; the 3-instruction guard around each body is not
    counted."""
    cfg = _kernel_cfg(text, kernel)
    rounds = []
    for h, (body, _) in cfg.loops.items():
        blocks = [cfg.blocks[s] for s in body]
        if (any(b.has("BAR") for b in blocks)
                and any(b.has("DMUL") for b in blocks)
                and any(b.has("STS") for b in blocks)
                and not any(b.has("LDG") or b.has("STG") for b in blocks)):
            rounds.append(h)
    rounds = [h for h in rounds
              if not any(g != h and cfg.loops[g][0] < cfg.loops[h][0]
                         for g in rounds)]
    if len(rounds) != 1:
        raise ValueError(f"{kernel}: {len(rounds)} round loops, not 1")
    blocks = [cfg.blocks[s] for s in sorted(cfg.loops[rounds[0]][0])]

    def bodies(need, avoid):
        return [b for b in blocks if all(b.has(op) for op in need)
                and not any(b.has(op) for op in avoid)]

    a = bodies(("LDS", "FMUL", "STS"), ("DMUL", "MUFU", "F2F"))
    v = bodies(("LDS", "DMUL", "STS"), ("MUFU", "F2F", "FMUL"))
    if not a or not v:
        raise ValueError(f"{kernel}: {len(a)} A block and {len(v)} V unit "
                         "bodies in the round loop")
    return tuple({cls: min(found, key=lambda b: b.count("issue")).count(cls)
                  for cls in CLASSES} for found in (a, v))
