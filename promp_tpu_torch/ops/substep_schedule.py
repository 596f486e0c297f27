"""Warp-split schedule of the emitted substep (K2 and K3).

The spatial emitter's C back end (envs/mujoco/spatial.py, ``CEmitter``)
records the substep as single-assignment lines ``tN = <expr>`` with the
temporaries each reads. ``Schedule`` partitions the live lines over
``n_parts`` parts (one warp each in the kernel, csrc/substep_chain.cu) and
over stages separated by block barriers:

  * every live operation lies in exactly one (stage, part) and is
    computed there once, from the same operands as in the one-thread
    body, so the kernel rounds exactly as before;
  * an operation reads the substep's inputs (q, qd, tau and the mods
    row m), values produced in an earlier stage, or values its own part
    produced earlier in the same stage; so one barrier after each stage
    orders every cross-part read;
  * a value read by another part lives in a shared-memory slot
    ``s[slot][lane]``, a slot reused only after the stage of its last
    reader; a value read by its own part in a later stage lives in a
    register slot ``r[k]`` of that part's threads (the numbers are reused
    across parts, so the kernel holds as many as the busiest part needs);
    constants (lifted literals) are written where they are read.

The heuristic is list scheduling stage by stage: the ready operations,
highest first by their weighted distance to the substep's end, go to a
part under the stage's cap (the ready work's share a part, at least
``min_cap``), preferring the part that holds most of their operands; an
operation whose same-stage operands lie on one part may join that part
while it is under the cap; one whose same-stage operands lie on two parts
waits for the next stage. Weights count a division, sqrtf, cosf and sinf
as the several instructions each becomes without fast math.
"""
from __future__ import annotations

import heapq

__all__ = ["Schedule", "op_weight"]


def op_weight(expr):
    """Issue-slot weight of one emitted expression (a scheduling estimate,
    not a count: ``n_ops`` counts float operations)."""
    if "cosf(" in expr or "sinf(" in expr:
        return 20
    if "sqrtf(" in expr or " / " in expr:
        return 8
    if "nan_min(nan_max(" in expr:
        return 6
    if "nan_max(" in expr or "nan_min(" in expr:
        return 3
    if "?" in expr:
        return 2
    return 1


class Schedule:
    """The schedule of ``lines`` (``CEmitter.lines``) whose live outputs
    are the temporaries ``outputs`` (q2 then qd2), over ``n_parts`` parts.

    ``blocks[s][p]``: the temporaries part p computes in stage s, in
    order. ``stage_of``/``part_of``: each computed temporary's place.
    ``slot_of``: the shared slot of each value another part reads;
    ``reg_of``: the register slot of each value only its own part reads
    in a later stage. ``consts``: the live lifted literals. ``stats()``
    summarises it."""

    def __init__(self, lines, outputs, n_parts, min_cap):
        self.lines, self.n_parts = lines, n_parts
        self.outputs = list(outputs)
        live = set()
        stack = list(self.outputs)
        while stack:
            i = stack.pop()
            if i not in live:
                live.add(i)
                stack.extend(lines[i][2])
        self.consts = {i for i in live if lines[i][1] == 0 and
                       not lines[i][2]}
        nodes = sorted(live - self.consts)
        self.n_ops = sum(lines[i][1] for i in live)
        deps = {i: sorted(set(lines[i][2]) - self.consts) for i in nodes}
        users = {i: [] for i in nodes}
        for i in nodes:
            for d in deps[i]:
                users[d].append(i)
        weight = {i: op_weight(lines[i][0]) for i in nodes}
        height, depth = {}, {}
        for i in reversed(nodes):
            height[i] = weight[i] + max((height[u] for u in users[i]),
                                        default=0)
        for i in nodes:
            depth[i] = lines[i][1] + max((depth[d] for d in deps[i]),
                                         default=0)
        self.critical_path = max(depth.values())
        self.weight = weight

        stage_of, part_of, blocks = {}, {}, []
        waiting = {i: len(deps[i]) for i in nodes}
        ready = [i for i in nodes if not waiting[i]]
        while ready:
            s = len(blocks)
            blocks.append([[] for _ in range(n_parts)])
            load = [0] * n_parts
            cap = max(min_cap, -(-sum(weight[i] for i in ready) // n_parts))
            heap = [(-height[i], i) for i in ready]
            heapq.heapify(heap)
            deferred = []
            while heap:
                _, i = heapq.heappop(heap)
                here = {part_of[d] for d in deps[i] if stage_of[d] == s}
                if len(here) > 1:
                    deferred.append(i)
                    continue
                parts = here or range(n_parts)
                # prefer the part holding most of the operands' weight,
                # then the least loaded
                near = [0] * n_parts
                for d in deps[i]:
                    near[part_of[d]] += weight[d]
                fits = [p for p in parts
                        if not load[p] or load[p] + weight[i] <= cap]
                if not fits:
                    deferred.append(i)
                    continue
                p = min(fits, key=lambda p: (-near[p], load[p], p))
                stage_of[i], part_of[i] = s, p
                blocks[s][p].append(i)
                load[p] += weight[i]
                for u in users[i]:
                    waiting[u] -= 1
                    if not waiting[u]:
                        heapq.heappush(heap, (-height[u], u))
            ready = deferred
        if len(stage_of) != len(nodes):
            raise AssertionError("schedule left operations unplaced")
        self.blocks, self.stage_of, self.part_of = blocks, stage_of, part_of

        # readers: the (stage, part) blocks that read each value
        last_read, readers = {}, {i: set() for i in nodes}
        for i in nodes:
            for d in deps[i]:
                readers[d].add((stage_of[i], part_of[i]))
        self.slot_of, self.reg_of = {}, {}
        shared, regs = [], []
        for i in nodes:
            own, s0 = part_of[i], stage_of[i]
            later = {(s, p) for s, p in readers[i] if (s, p) != (s0, own)}
            if not later:
                continue
            last_read[i] = max(s for s, _ in later)
            if any(p != own for _, p in later):
                shared.append(i)
            else:
                regs.append(i)
        self.last_read = last_read
        self.n_slots = _colour(shared, stage_of, last_read, self.slot_of,
                               strict=True)
        self.n_regs = 0
        for p in range(n_parts):
            mine = [i for i in regs if part_of[i] == p]
            self.n_regs = max(self.n_regs, _colour(
                mine, stage_of, last_read, self.reg_of, strict=False))

    @property
    def n_stages(self):
        return len(self.blocks)

    def stats(self):
        """The schedule's figures, a dict: parts, stages (barriers) a
        substep, float ops a substep and each part's share with the
        busiest, the sum over stages of the busiest part's weight (issue
        slots a substep if a stage lasts as long as its busiest part), the
        critical path in ops, shared slots and their bytes for 32 lanes,
        and register slots."""
        part_ops = [0] * self.n_parts
        for i, p in self.part_of.items():
            part_ops[p] += self.lines[i][1]
        return dict(
            parts=self.n_parts, stages=self.n_stages, ops=self.n_ops,
            part_ops=part_ops, max_part_ops=max(part_ops),
            busiest_weight=sum(
                max(sum(self.weight[i] for i in block) for block in stage)
                for stage in self.blocks),
            critical_path=self.critical_path, shared_slots=self.n_slots,
            shared_bytes=self.n_slots * 32 * 4, register_slots=self.n_regs)


def _colour(values, stage_of, last_read, out, strict):
    """Gives each value a slot number in ``out`` such that two values
    share a slot only if one's last read comes before the other's write
    (``strict``: in an earlier stage, as for shared memory, where another
    part may write while one reads; else in the same or an earlier stage,
    as for one thread's registers, which a block reads before it writes);
    returns the number of slots."""
    free, busy, n = [], [], 0
    for i in sorted(values, key=lambda i: (stage_of[i], i)):
        s = stage_of[i]
        while busy and (busy[0][0] < s if strict else busy[0][0] <= s):
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            slot = heapq.heappop(free)
        else:
            slot, n = n, n + 1
        out[i] = slot
        heapq.heappush(busy, (last_read[i], slot))
    return n
