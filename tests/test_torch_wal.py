"""The port's write-ahead log against the JAX package's, on the CPU.

``tests/test_wal_recovery.py``'s WAL unit tests (record framing and torn
tails, segment naming, rotation and truncation, restore across segments
and at the first torn one, the 'group' and 'every' acknowledgement rules,
power loss with and without a torn record), its tree-level configuration
and planned-shutdown tests and its fsync-failure tests, each run on the
reference's ``repro.core.wal`` / ``repro.LSMTree`` and on the port's.  Then
the same operations through both writers must leave segment files that are
byte for byte the same, under 'group' and 'every', and a single bit flip
must cut both parsers at the same record.
"""

import os
import random

import pytest

import repro.core as R
import repro.core.wal as rwal
import repro_torch.core as T
import repro_torch.core.wal as twal
from repro_torch.testing.workload import (apply_op, gen_ops, mutations,
                                          oracle_state, value_for)

VW = 32
KEY_SPACE = 1200
ENGINES = ["ref", "port"]


@pytest.fixture(params=ENGINES)
def W(request):
    """The WAL module of one engine."""
    return rwal if request.param == "ref" else twal


def _tree(engine, wal="every", spill_dir=None):
    kw = dict(codec="opd", value_width=VW, memtable_bytes=8 * 1024,
              file_bytes=16 * 1024, l0_limit=2, size_ratio=3, max_levels=5,
              blob_gc_threshold=0.3, wal_sync=wal, filter_backend="numpy",
              compaction_backend="numpy")
    if engine == "ref":
        return R.LSMConfig(**kw), lambda cfg, **a: R.LSMTree(cfg, **a), \
            R.LSMTree.restore
    return (T.LSMConfig(**kw),
            lambda cfg, **a: T.LSMTree(cfg, device="cpu", **a),
            lambda cfg, d: T.LSMTree.restore(cfg, d, device="cpu"))


def _names(path):
    return sorted(p.name for p in path.iterdir())


# --------------------------------------------------------------------------- #
# WAL unit behavior, on both engines
# --------------------------------------------------------------------------- #
def test_record_roundtrip_and_torn_tail(W):
    recs = [W.encode_record(W.OP_PUT, i + 1, i * 7, value_for(i))
            for i in range(20)]
    recs.append(W.encode_record(W.OP_DELETE, 21, 3))
    data = b"".join(recs)
    out, good, clean = W.parse_segment(data)
    assert clean and good == len(data)
    assert [r.seqno for r in out] == list(range(1, 22))
    assert out[0] == W.WALRecord(W.OP_PUT, 1, 0, value_for(0))
    assert out[-1] == W.WALRecord(W.OP_DELETE, 21, 3, b"")
    for cut in (len(data) - 1, len(data) - len(recs[-1]) + 2):
        out2, good2, clean2 = W.parse_segment(data[:cut])
        assert not clean2
        assert len(out2) == 20 and good2 == len(data) - len(recs[-1])
    flipped = bytearray(data)
    flipped[len(recs[0]) + 12] ^= 0xFF
    out3, _, clean3 = W.parse_segment(bytes(flipped))
    assert not clean3 and len(out3) == 1
    # the framing is the reference's, byte for byte
    assert data == b"".join(
        rwal.encode_record(r.op, r.seqno, r.key, r.value) for r in out)


@pytest.mark.parametrize("engine", ENGINES)
def test_tree_names_its_segments_and_manifest(engine, tmp_path):
    """A tree's WAL segments are ``WAL-<segno>.wal`` beside its
    ``MANIFEST.log``, numbered from 0, one more at each flush."""
    cfg, make, _ = _tree(engine, "group")
    t = make(cfg, spill_dir=str(tmp_path))
    for k in range(200):
        t.put(k, value_for(k, VW))
    assert t.n_flushes == 1
    names = [n for n in _names(tmp_path) if not n.endswith(".bin")]
    assert names == ["MANIFEST.log", "WAL-00000001.wal"]
    t.close()


def test_segment_rotation_and_truncation(W, tmp_path):
    w = W.WALWriter(str(tmp_path), sync="every")
    for seq in range(1, 11):
        w.append(W.OP_PUT, seq, seq, b"v%d" % seq)
    w.rotate()
    for seq in range(11, 16):
        w.append(W.OP_PUT, seq, seq, b"v%d" % seq)
    w.rotate()
    assert _names(tmp_path) == ["WAL-00000000.wal", "WAL-00000001.wal"]
    w.truncate_upto(10)   # the flush watermark covers the first segment only
    assert _names(tmp_path) == ["WAL-00000001.wal"]
    w.truncate_upto(15)
    assert list(tmp_path.iterdir()) == []
    w.close()


def test_restore_replays_segments_in_order(W, tmp_path):
    w = W.WALWriter(str(tmp_path), sync="every")
    for seq in range(1, 8):
        w.append(W.OP_PUT, seq * 3, seq, b"val%02d" % seq)
        if seq % 3 == 0:
            w.rotate()
    w.close()
    back, records = W.WALWriter.restore(str(tmp_path), sync="every")
    assert [r.seqno for r in records] == list(range(1, 8))
    assert back.durable_seqno == 7 and back.replayed == 7
    back.append(W.OP_PUT, 99, 8, b"post")   # into a fresh segment
    back.close()
    _, records2 = W.WALWriter.restore(str(tmp_path), sync="every")
    assert [r.seqno for r in records2] == list(range(1, 9))


def test_restore_stops_at_first_torn_segment(W, tmp_path):
    w = W.WALWriter(str(tmp_path), sync="every")
    for seq in range(1, 5):
        w.append(W.OP_PUT, seq, seq, b"a")
    w.rotate()
    for seq in range(5, 9):
        w.append(W.OP_PUT, seq, seq, b"b")
    w.rotate()
    w.close()
    seg0 = tmp_path / "WAL-00000000.wal"
    data = seg0.read_bytes()
    seg0.write_bytes(data[:len(data) - 5])
    _, records = W.WALWriter.restore(str(tmp_path), sync="every")
    assert [r.seqno for r in records] == [1, 2, 3]
    assert _names(tmp_path) == ["WAL-00000000.wal"]
    _, again = W.WALWriter.restore(str(tmp_path), sync="every")
    assert [r.seqno for r in again] == [1, 2, 3]


def test_group_vs_every_ack_semantics(W, tmp_path):
    we = W.WALWriter(str(tmp_path), prefix="EV", sync="every")
    we.append(W.OP_PUT, 1, 1, b"x")
    assert we.durable_seqno == 1
    wg = W.WALWriter(str(tmp_path), prefix="GR", sync="group",
                     group_bytes=1 << 20)
    wg.append(W.OP_PUT, 1, 1, b"x")
    wg.append(W.OP_PUT, 2, 2, b"y")
    assert wg.durable_seqno == 0 and wg.syncs == 0
    wg.sync()
    assert wg.durable_seqno == 2 and wg.syncs == 1
    wg2 = W.WALWriter(str(tmp_path), prefix="GB", sync="group",
                      group_bytes=64)
    for seq in range(1, 10):
        wg2.append(W.OP_PUT, seq, seq, b"z" * 30)
    assert wg2.durable_seqno > 0 and wg2.syncs >= 1
    for w in (we, wg, wg2):
        w.close()


def test_power_loss_drops_unsynced_tail(W, tmp_path):
    w = W.WALWriter(str(tmp_path), sync="group", group_bytes=1 << 20)
    for seq in range(1, 6):
        w.append(W.OP_PUT, seq, seq, b"v")
    w.sync()
    for seq in range(6, 9):
        w.append(W.OP_PUT, seq, seq, b"v")   # never synced
    w.simulate_power_loss()
    _, records = W.WALWriter.restore(str(tmp_path), sync="group")
    assert [r.seqno for r in records] == [1, 2, 3, 4, 5]


def test_power_loss_torn_record_recovers_prefix(W, tmp_path):
    w = W.WALWriter(str(tmp_path), sync="group", group_bytes=1 << 20)
    for seq in range(1, 6):
        w.append(W.OP_PUT, seq, seq, b"v")
    w.sync()
    w.append(W.OP_PUT, 6, 6, b"half-written")
    w.simulate_power_loss(tear=True)
    _, records = W.WALWriter.restore(str(tmp_path), sync="group")
    assert [r.seqno for r in records] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("engine", ENGINES)
def test_wal_config_validation(engine, tmp_path):
    cfg, make, _ = _tree(engine)
    with pytest.raises(ValueError, match="spill_dir"):
        make(cfg)                             # a memory store: no WAL home
    bad = dict(cfg.__dict__, wal_sync="sometimes")
    with pytest.raises(ValueError, match="wal"):
        make(type(cfg)(**bad), spill_dir=str(tmp_path))
    off = type(cfg)(**dict(cfg.__dict__, wal_sync="off"))
    with make(off, spill_dir=str(tmp_path / "o")) as t:
        t.put(1, b"x")
        assert t.wal is None
        assert not any(n.endswith(".wal")
                       for n in os.listdir(t.store.spill_dir))


@pytest.mark.parametrize("engine", ENGINES)
def test_planned_shutdown_loses_nothing(engine, tmp_path):
    """close() syncs the WAL tail: a clean restart has the full state, in
    group mode with an unsynced tail at close time too."""
    for wal in ("group", "every"):
        spill = str(tmp_path / wal)
        cfg, make, restore = _tree(engine, wal)
        t = make(cfg, spill_dir=spill)
        ops = gen_ops(3, 500, KEY_SPACE)
        for op in ops:
            apply_op(t, op)
        t.close()
        back = restore(cfg, spill)
        muts = mutations(ops)
        assert back._seqno == len(muts)
        ka, va = back.range_lookup(0, KEY_SPACE)
        assert {int(k): bytes(v) for k, v in zip(ka, va)} \
            == oracle_state(muts, len(muts))
        back.close()


# --------------------------------------------------------------------------- #
# fsync failure: a failed fsync poisons the writer, on both engines
# --------------------------------------------------------------------------- #
def _failing_fsync(real, suffix=".wal"):
    def boom(fd):
        try:
            path = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            path = ""
        if path.endswith(suffix):
            raise OSError(5, "Input/output error")
        return real(fd)
    return boom


def test_fsync_failure_poisons_wal_writer(W, tmp_path, monkeypatch):
    w = W.WALWriter(str(tmp_path), sync="every")
    w.append(W.OP_PUT, 1, 1, b"a")
    assert w.durable_seqno == 1
    real = os.fsync
    monkeypatch.setattr(os, "fsync", _failing_fsync(real))
    with pytest.raises(W.WALError):
        w.append(W.OP_PUT, 2, 2, b"b")
    monkeypatch.setattr(os, "fsync", real)
    with pytest.raises(W.WALError):
        w.append(W.OP_PUT, 3, 3, b"c")
    with pytest.raises(W.WALError):
        w.sync()
    assert w.durable_seqno == 1
    w.close()
    path = os.path.join(str(tmp_path), "WAL-00000000.wal")
    recs, _, clean = W.parse_segment(open(path, "rb").read())
    assert clean and [r.seqno for r in recs] in ([1], [1, 2])


@pytest.mark.parametrize("engine", ENGINES)
def test_tree_fsync_failure_fails_writes_durable_prefix_survives(
        engine, tmp_path, monkeypatch):
    W = rwal if engine == "ref" else twal
    cfg, make, restore = _tree(engine, "every")
    tree = make(cfg, spill_dir=str(tmp_path))
    for i in range(50):
        tree.put(i, value_for(i))
    durable = tree.wal.durable_seqno
    assert durable == 50
    monkeypatch.setattr(os, "fsync", _failing_fsync(os.fsync))
    with pytest.raises(W.WALError):
        tree.put(50, value_for(50))
    with pytest.raises(W.WALError):
        tree.put(51, value_for(51))
    assert tree.wal.durable_seqno == durable
    monkeypatch.undo()
    tree.wal.close()
    back = restore(cfg, str(tmp_path))
    K = back._seqno
    assert durable <= K <= 51
    muts = [("put", i, value_for(i)) for i in range(52)]
    ka, va = back.range_lookup(0, KEY_SPACE)
    assert {int(k): bytes(v) for k, v in zip(ka, va)} == oracle_state(muts, K)
    back.close()


# --------------------------------------------------------------------------- #
# the same operations leave the same bytes
# --------------------------------------------------------------------------- #
def _drive(W, d, sync):
    """One fixed schedule of appends, barriers, rotations, truncations, a
    close, a restore with its appends and a torn power loss."""
    w = W.WALWriter(str(d), sync=sync, group_bytes=256)
    rng = random.Random(5)
    seq = 0
    for step in range(120):
        seq += 1
        if rng.random() < 0.15:
            w.append(W.OP_DELETE, rng.randrange(1 << 40), seq)
        else:
            w.append(W.OP_PUT, rng.randrange(1 << 40), seq,
                     value_for(seq, rng.randrange(0, 40)))
        if step % 17 == 16:
            w.sync()
        if step % 29 == 28:
            w.rotate()
        if step % 41 == 40:
            w.truncate_upto(seq - 30)
    w.close()
    back, records = W.WALWriter.restore(str(d), sync=sync, group_bytes=256)
    for _ in range(9):
        seq += 1
        back.append(W.OP_PUT, seq, seq, b"post_%03d" % seq)
    back.simulate_power_loss(tear=True)
    return [(r.op, r.seqno, r.key, r.value) for r in records], \
        (back.appends, back.syncs, back.durable_seqno, back.bytes_written)


@pytest.mark.parametrize("sync", ["group", "every"])
def test_segments_are_byte_for_byte_the_reference(tmp_path, sync):
    a, b = tmp_path / "ref", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    assert _drive(rwal, a, sync) == _drive(twal, b, sync)
    assert _names(a) == _names(b) and len(_names(a)) >= 2
    for name in _names(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_single_bit_flip_cuts_both_parsers_alike():
    """A single bit flip only shortens the parsed stream, never alters or
    reorders it, and both parsers stop at the same record."""
    rng = random.Random(0xC0FFEE)
    for _ in range(150):
        recs = []
        for i in range(rng.randint(1, 12)):
            op = twal.OP_PUT if rng.random() < 0.8 else twal.OP_DELETE
            value = bytes(rng.randrange(256)
                          for _ in range(rng.randrange(0, 40))) \
                if op == twal.OP_PUT else b""
            recs.append(twal.encode_record(op, i + 1, rng.randrange(1 << 62),
                                           value))
        data = bytearray(b"".join(recs))
        bit = rng.randrange(len(data) * 8)
        data[bit // 8] ^= 1 << (bit % 8)
        got, good, clean = twal.parse_segment(bytes(data))
        want, rgood, rclean = rwal.parse_segment(bytes(data))
        assert [tuple(r.__dict__.values()) for r in got] == \
            [tuple(r.__dict__.values()) for r in want]
        assert (good, clean) == (rgood, rclean) and not clean
        j, off = 0, 0
        while bit // 8 >= off + len(recs[j]):
            off += len(recs[j])
            j += 1
        assert len(got) == j and good == off
