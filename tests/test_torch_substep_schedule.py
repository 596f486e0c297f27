"""The warp-split schedule of K2's and K3's emitted substep
(promp_tpu_torch/ops/substep_schedule.py), checked for validity on the
three bodies the port runs, with and without the rand-params mods, and
``Schedule`` alone at 16 and 32 parts on the walker: every live operation is placed once;
every operand is a constant, an input, a value of an earlier stage, or one
its own part produced earlier in the same stage; a value another part
reads lies in a shared slot and one only its own part reads later in a
shared slot or a register slot; no slot is written while a reader of its
previous value is pending; the figures add up. (The numerics of the
scheduled source are held in tests/test_torch_spatial.py and
test_torch_substep_mods.py.)

The warps a body's source takes: the most of 8, 4, 2 and 1 whose block
fits the H100's 227 KB of shared memory (ant 8, humanoid 1, the other
bodies 8); and the K2 and K3 sources of half_cheetah, walker2d and hopper
pinned by their sha256, as they were before the warp count was derived.
The ant's and the humanoid's sources (1.3 and 1.5 MB) are not built for
the host here: chip_smoke.py holds their kernels bitwise against the
plain version on the card."""
import hashlib

import pytest

torch = pytest.importorskip("torch")

from test_torch_support import torch_single_thread  # noqa: E402,F401

from promp_tpu_torch.envs.mujoco.engine import Engine  # noqa: E402
from promp_tpu_torch.envs.mujoco.model import get_model  # noqa: E402
from promp_tpu_torch.ops import substep_kernel as sk  # noqa: E402
from promp_tpu_torch.ops.substep_schedule import (  # noqa: E402
    Schedule, op_weight)

KEYS = ("body_inertia", "body_mass", "dof_damping", "friction")


def _live(lines, outputs):
    live, stack = set(), list(outputs)
    while stack:
        i = stack.pop()
        if i not in live:
            live.add(i)
            stack.extend(lines[i][2])
    return live


def _check_slots(values, sched, table, strict):
    """Values sharing a slot of ``table`` do not overlap: each later one is
    written after (``strict``) or in (else) the stage of the previous one's
    last read."""
    by_slot = {}
    for i in values:
        by_slot.setdefault(table[i], []).append(i)
    for slot, vals in by_slot.items():
        vals.sort(key=lambda i: sched.stage_of[i])
        for a, b in zip(vals, vals[1:]):
            w, last = sched.stage_of[b], sched.last_read[a]
            assert w > last if strict else w >= last, (slot, a, b)


@pytest.mark.parametrize("name,keys,parts", [
    ("walker2d", KEYS, sk.PARTS), ("walker2d", (), sk.PARTS),
    ("hopper", KEYS, sk.PARTS), ("hopper", (), sk.PARTS),
    ("half_cheetah", KEYS, sk.PARTS), ("half_cheetah", (), sk.PARTS),
    ("ant", (), sk.PARTS), ("walker2d", KEYS, 16), ("walker2d", KEYS, 32)])
def test_schedule_is_valid(name, keys, parts):
    src = sk.SubstepSource(Engine(get_model(name)), keys)
    sched = src.schedule
    if parts != sk.PARTS:
        sched = Schedule(sched.lines, sched.outputs, parts, sk.MIN_CAP)
    lines = sched.lines
    nv = get_model(name).nv
    assert len(sched.outputs) == 2 * nv
    live = _live(lines, sched.outputs)
    consts = {i for i in live if lines[i][1] == 0 and not lines[i][2]}
    assert sched.consts == consts
    assert all(op_weight(lines[i][0]) >= 1 for i in live - consts)

    # every live operation exactly once, in the block its place names
    placed = [i for stage in sched.blocks for block in stage for i in block]
    assert len(placed) == len(set(placed))
    assert set(placed) == live - consts == set(sched.part_of)
    assert len(sched.blocks[0]) == parts
    pos = {}
    for s, stage in enumerate(sched.blocks):
        for p, block in enumerate(stage):
            for k, i in enumerate(block):
                assert (sched.stage_of[i], sched.part_of[i]) == (s, p)
                pos[i] = k

    # operands: earlier stage, or earlier in the same part and stage; what
    # crosses parts is in a shared slot, what stays in the part and crosses
    # stages in a slot or a register
    for i in placed:
        s, p = sched.stage_of[i], sched.part_of[i]
        for d in set(lines[i][2]) - consts:
            sd, pd = sched.stage_of[d], sched.part_of[d]
            if sd == s:
                assert pd == p and pos[d] < pos[i], (i, d)
                continue
            assert sd < s, (i, d)
            assert sched.last_read[d] >= s
            if pd != p:
                assert d in sched.slot_of, (i, d)
            else:
                assert d in sched.slot_of or d in sched.reg_of, (i, d)
    assert not set(sched.slot_of) & set(sched.reg_of)
    _check_slots(sched.slot_of, sched, sched.slot_of, strict=True)
    for p in range(parts):
        _check_slots([i for i in sched.reg_of if sched.part_of[i] == p],
                     sched, sched.reg_of, strict=False)
    assert max(sched.slot_of.values()) + 1 == sched.n_slots
    assert max(sched.reg_of.values(), default=-1) + 1 == sched.n_regs

    # the figures
    stats = sched.stats()
    assert stats["ops"] == src.n_ops == sum(stats["part_ops"])
    assert stats["max_part_ops"] == max(stats["part_ops"])
    assert stats["parts"] == parts and stats["stages"] == sched.n_stages
    assert stats["shared_bytes"] == 128 * stats["shared_slots"]
    assert stats["critical_path"] < stats["max_part_ops"] < stats["ops"]
    if parts != sk.PARTS:
        return
    assert src.stats == stats
    assert f"constexpr int kSlots = {sched.n_slots};" in src.text
    assert f"constexpr int kRegs = {sched.n_regs};" in src.text


# sha256 of the generated sources of the bodies that keep 8 warps
# (Engine(get_model(name)), chip_smoke.py's engines), as they were emitted
# before the warp count was derived from the block's shared memory
SOURCE_SHA256 = {
    ("half_cheetah", ()):
        "305636180b0d1ae9d4135d29500f6ed6d155d2d8258ea3c411f39345291246e0",
    ("half_cheetah", KEYS):
        "91459d958a32c4440b5040be74027fe9c8fb248004b42f7493b0fd5161bd3ba9",
    ("walker2d", ()):
        "b5384e3f0a73e7577731638ac48140116f5b0ffd1f2d238426ec5056ecd8c667",
    ("walker2d", KEYS):
        "6fe5845d4ad5ea1fa1bb62562ccbaaa0b518f34b45fba554f9fa5794bb7ca0bb",
    ("hopper", ()):
        "d352fd96415866aab6b48025ca13d3355f522087890fb48a5378282d7faf7b90",
    ("hopper", KEYS):
        "5b32028b259cb06561a4a6d6e21665656f5d75d3d9e572689170b2d7a98418a5",
}


@pytest.mark.parametrize("name,keys", sorted(SOURCE_SHA256))
def test_planar_sources_unchanged(name, keys):
    src = sk.SubstepSource(Engine(get_model(name)), keys)
    assert src.parts == sk.PARTS
    assert hashlib.sha256(src.text.encode()).hexdigest() == SOURCE_SHA256[
        (name, keys)]


@pytest.mark.parametrize("env_name,parts", [("AntRandGoalEnv", 8),
                                            ("HumanoidRandDirecEnv", 1)])
def test_parts_derived_from_the_block(env_name, parts):
    from promp_tpu_torch.envs import make_env

    engine = make_env(env_name).engine
    src = sk.SubstepSource(engine)
    assert src.parts == parts
    assert f"constexpr int kParts = {parts};" in src.text
    assert src.block_bytes == sk.block_bytes(engine.model.nv, 0,
                                             src.schedule.n_slots)
    assert src.block_bytes <= sk.MAX_BLOCK_BYTES
    if parts < sk.PARTS:
        # twice the warps would not fit
        wider = Schedule(src.schedule.lines, src.schedule.outputs, 2 * parts,
                         sk.MIN_CAP)
        assert sk.block_bytes(engine.model.nv, 0,
                              wider.n_slots) > sk.MAX_BLOCK_BYTES


def test_load_launch_refuses_a_block_the_card_cannot_hold(monkeypatch):
    """The wrapper raises, before any build, where a block takes more
    shared memory than the card lets it opt in to: nothing runs the plain
    version on the card instead."""
    class Props:
        name = "a card with 48 KB a block"
        shared_memory_per_block_optin = 48 * 1024

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    monkeypatch.setattr(sk.nvcc_build, "build",
                        lambda *args: pytest.fail("built"))
    engine = Engine(get_model("half_cheetah"))     # 69,760 B a block
    with pytest.raises(RuntimeError, match="more than the 49152 B"):
        sk.load_launch(engine, device=0)
