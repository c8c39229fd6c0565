"""Deterministic recovery workload shared by tests and the crash driver
(port of ``repro/testing/workload.py``).

Both sides of a crash test must agree byte-for-byte on the op sequence:
the dying process applies ``gen_ops(seed, ...)`` until the armed site
fires, and the checker replays the *acknowledged prefix* of the same
sequence on a fresh tree to produce the expected state.  Everything
here is pure and seeded — no wall clock, no global RNG.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

Op = Tuple  # ("put", key, value) | ("delete", key) | ("flush",) | ("compact",)


def value_for(i: int, width: int = 0) -> bytes:
    """Value payload for the i-th mutation.  The ``pfx_NNN_`` prefix
    cycles through 60 buckets so predicate filters partition the
    keyspace non-trivially; the suffix keeps payloads distinguishable
    so a lost/duplicated record shows up as a value mismatch, not just
    a count skew."""
    v = b"pfx_%03d_v%07d" % (i % 60, i)
    if width > len(v):
        v += b"x" * (width - len(v))
    return v


def gen_ops(seed: int, n: int, key_space: int,
            p_delete: float = 0.12, p_flush: float = 0.008,
            p_compact: float = 0.002) -> List[Op]:
    """n mutations (puts/deletes) plus interleaved flush/compact hints.

    Mutations dominate so seqno advances steadily; the occasional
    explicit flush/compact drags maintenance (and its crash sites) into
    the schedule even for tiny workloads."""
    rng = random.Random(seed)
    ops: List[Op] = []
    muts = 0
    while muts < n:
        r = rng.random()
        if r < p_flush:
            ops.append(("flush",))
        elif r < p_flush + p_compact:
            ops.append(("compact",))
        elif r < p_flush + p_compact + p_delete:
            ops.append(("delete", rng.randrange(key_space)))
            muts += 1
        else:
            ops.append(("put", rng.randrange(key_space), value_for(muts)))
            muts += 1
    return ops


def mutations(ops: List[Op]) -> List[Op]:
    """Just the seqno-consuming ops, in order (flush/compact stripped)."""
    return [op for op in ops if op[0] in ("put", "delete")]


def apply_op(eng, op: Op) -> None:
    """Apply one op to an LSMTree or a ShardedLSM (which compacts through
    ``compact_all``)."""
    kind = op[0]
    if kind == "put":
        eng.put(op[1], op[2])
    elif kind == "delete":
        eng.delete(op[1])
    elif kind == "flush":
        eng.flush()
    elif kind == "compact":
        if hasattr(eng, "compact"):
            eng.compact()
        else:
            eng.compact_all()
    else:  # pragma: no cover - generator bug
        raise ValueError(f"unknown op {op!r}")


def oracle_state(muts: List[Op], k: int) -> Dict[int, bytes]:
    """Live key->value map after the first ``k`` mutations."""
    state: Dict[int, bytes] = {}
    for op in muts[:k]:
        if op[0] == "put":
            state[op[1]] = op[2]
        else:
            state.pop(op[1], None)
    return state
