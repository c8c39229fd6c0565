"""One replicated shard: a leader ``LSMTree`` plus N followers fed by
WAL shipping, bounded-staleness read routing, and crash-safe failover.

Port of ``repro/replica/replicated.py``.  The group resolves one device
(``resolve_device``: the card unless the caller passes ``device='cpu'``)
and builds and restores every replica on it, so all of them flush, compact
and serve reads through the card's kernels; the protocol itself is host
code.

Topology and protocol:

* Every replica is a full ``LSMTree`` in its own spill dir under the
  group root (``r0``, ``r1``, ...), with its own WAL, manifest, and
  maintenance pipeline.  The leader's WAL tap feeds a shared
  ``ReplicationLog``; ``pump`` ships the missing suffix to each
  follower over its ``ReplicationLink``, and followers apply records
  with the LEADER's seqnos (``LSMTree.replicate``), so a follower's
  ``_seqno`` is its contiguous applied watermark and its WAL's
  ``durable_seqno`` is its promotion floor.

* Reads route by ``ReadPolicy(max_lag_seqnos=...)``: the freshest
  follower whose lag (leader head minus applied watermark) is within
  the bound serves the read against its own MVCC snapshot; ties break
  round-robin (capacity scaling), and when every follower exceeds the
  bound the leader serves.  Every routed read records its observed lag
  in ``read_stats`` (counts: follower_reads / leader_reads /
  read_lag_total / read_lag_max), so tests can assert the staleness
  bound was never exceeded.

* ``promote(idx)`` is the failover path, crash-safe around the
  ``promote.*`` fault sites: catch the target up (when the old leader
  is alive), fence the old epoch (the leader's WAL tap is disconnected,
  so a zombie leader can no longer feed the stream), sync the target's
  WAL so applied == durable, then atomically persist the new epoch
  record — the EPOCH-file rename IS the commit point — truncate the
  retention log above the new watermark, and re-point routing.
  Surviving replicas whose state runs past the new watermark hold
  writes the new epoch never acknowledged; they are dropped as
  divergent and rejoin via snapshot resync.

* ``restore`` recovers a whole group after a coordinator crash (e.g.
  mid-promote): the EPOCH file names the authoritative leader, every
  replica dir restores to its durable prefix, and misaligned followers
  are snapshot-resynced off the leader.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.filter_exec import FilterResult
from repro_torch.core.lsm import LSMConfig, LSMTree, Snapshot, resolve_device
from repro_torch.core.opd import Predicate
from repro_torch.core.stats import StageStats
from repro_torch.replica.link import (ReplicationLag, ReplicationLink,
                                      ReplicationLog)
from repro_torch.testing.crashpoints import crashpoint

EPOCH_FILE = "EPOCH.json"
_REPLICA_DIR_RE = re.compile(r"r(\d+)")


def _replica_dir(root: str, idx: int) -> str:
    return os.path.join(root, f"r{idx}")


@dataclasses.dataclass(frozen=True)
class ReadPolicy:
    """Bounded-staleness routing for replica reads.

    ``max_lag_seqnos``: a follower may serve a read only while its
    applied watermark trails the leader head by at most this many
    seqnos (0 = followers must be fully caught up).  When no follower
    qualifies the leader serves — unless ``prefer_follower`` is False,
    in which case the leader always serves (the replication is then
    purely for durability/failover)."""

    max_lag_seqnos: int = 0
    prefer_follower: bool = True


@dataclasses.dataclass
class ReplicaSnapshot:
    """A routed MVCC snapshot: the chosen replica tree plus its pinned
    engine snapshot and the lag observed at routing time.  Read calls
    that accept it always execute against ``tree`` — a promote between
    pin and read is invisible, exactly like the sharded snapshots."""

    tree: LSMTree
    snap: Snapshot
    replica: int
    lag: int
    follower: bool

    @property
    def seqno(self) -> int:
        return self.snap.seqno


class ReplicatedShard:
    """Leader + N followers over one ``LSMConfig`` (see module doc)."""

    def __init__(self, cfg: LSMConfig, root_dir: str, n_followers: int = 2,
                 read_policy: Optional[ReadPolicy] = None,
                 auto_pump: bool = True, device=None):
        """``device`` is every replica's (the card by default)."""
        if cfg.wal_sync == "off":
            raise ValueError(
                "replication ships the WAL record stream; cfg.wal_sync "
                "must be 'group' or 'every'")
        self.cfg = cfg
        self.root = root_dir
        self.device = resolve_device(device)
        os.makedirs(root_dir, exist_ok=True)
        self.read_policy = read_policy if read_policy is not None \
            else ReadPolicy()
        self.auto_pump = auto_pump
        self.log = ReplicationLog()
        self.replicas: Dict[int, LSMTree] = {}
        for i in range(n_followers + 1):
            d = _replica_dir(root_dir, i)
            os.makedirs(d, exist_ok=True)
            self.replicas[i] = LSMTree(cfg, spill_dir=d, device=self.device)
        self._leader_idx = 0
        self.epoch = 1
        self._dead: Set[int] = set()
        self._ack_floor: Dict[int, int] = {}  # frozen acks of dead members
        self.links: Dict[int, ReplicationLink] = {
            i: ReplicationLink(self.log, t, name=f"r{i}")
            for i, t in self.replicas.items() if i != self._leader_idx}
        self.leader.wal.tap = self.log.append
        self.read_stats = StageStats()
        self.n_promotes = 0
        self.n_resyncs = 0
        self.n_divergent_dropped = 0
        self._rr = 0
        self._persist_epoch(self.epoch, self._leader_idx,
                            self.leader._seqno)

    # ------------------------------------------------------------------ #
    # topology
    # ------------------------------------------------------------------ #
    @property
    def leader(self) -> LSMTree:
        return self.replicas[self._leader_idx]

    @property
    def leader_idx(self) -> int:
        return self._leader_idx

    def live_followers(self) -> List[int]:
        return [i for i in self.links if i not in self._dead]

    def is_dead(self, idx: int) -> bool:
        return idx in self._dead

    def best_follower(self) -> Optional[int]:
        """The promotion candidate: the live follower with the highest
        applied watermark (ties break on the lower index)."""
        live = self.live_followers()
        if not live:
            return None
        return max(live, key=lambda i: (self.replicas[i]._seqno, -i))

    def _persist_epoch(self, epoch: int, leader: int,
                       watermark: int) -> None:
        """Atomic epoch record (tmp + fsync + rename): the failover
        commit point a post-crash ``restore`` routes by."""
        path = os.path.join(self.root, EPOCH_FILE)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".epoch-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"epoch": epoch, "leader": leader,
                           "watermark": watermark}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise

    # ------------------------------------------------------------------ #
    # writes (leader only)
    # ------------------------------------------------------------------ #
    def _writable_leader(self) -> LSMTree:
        if self._leader_idx in self._dead:
            raise RuntimeError(
                "leader is dead; promote a follower before writing")
        return self.leader

    def put(self, key: int, value: bytes) -> None:
        self._writable_leader().put(key, value)
        if self.auto_pump:
            self.pump()

    def delete(self, key: int) -> None:
        self._writable_leader().delete(key)
        if self.auto_pump:
            self.pump()

    def put_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        self._writable_leader().put_batch(keys, values)
        if self.auto_pump:
            self.pump()

    def flush(self) -> None:
        self._writable_leader().flush()

    def compact(self) -> None:
        self._writable_leader().compact()

    def drain(self) -> None:
        """Quiesce the whole group: ship everything outstanding (links
        permitting), then drain every live replica's maintenance."""
        if self._leader_idx not in self._dead:
            self.pump()
        for i, t in self.replicas.items():
            if i not in self._dead:
                t.drain()

    def raise_maintenance_errors(self, consume: bool = True) -> None:
        """Raise a live replica's background failure; a read-only caller
        (``ScanServer.step``) passes ``consume=False``, as to a tree."""
        for i, t in self.replicas.items():
            if i not in self._dead:
                t.raise_maintenance_errors(consume)

    # ------------------------------------------------------------------ #
    # shipping
    # ------------------------------------------------------------------ #
    def pump(self) -> int:
        """One shipping round: every live link delivers the suffix its
        follower is missing (subject to partition/lag fault state), then
        the retention log trims below the group's durable floor."""
        head = self.leader._seqno
        total = 0
        for i in list(self.links):
            if i in self._dead:
                continue
            total += self.links[i].pump(head)
        self._trim()
        return total

    def _trim(self) -> None:
        floors = [lk.durable_seqno for i, lk in self.links.items()
                  if i not in self._dead]
        floors += list(self._ack_floor.values())
        if floors:
            self.log.trim_below(min(floors))
        else:
            self.log.trim_below(self.leader._seqno)

    # ------------------------------------------------------------------ #
    # fault schedule hooks (the in-process analogue of process death)
    # ------------------------------------------------------------------ #
    def kill_leader(self) -> int:
        """SIGKILL the leader 'process': close its private background
        workers, truncate its WAL to the fsynced prefix (the strongest
        loss a power cut could inflict), and mark it dead.  Followers
        keep serving bounded-staleness reads until ``promote``."""
        i = self._leader_idx
        self._kill(i)
        return i

    def kill_follower(self, idx: int) -> None:
        if idx == self._leader_idx:
            raise ValueError("use kill_leader for the leader")
        self._kill(idx)

    def _kill(self, idx: int) -> None:
        t = self.replicas[idx]
        if t.wal is not None:
            t.wal.tap = None
        if t._sched is not None and t._owns_sched:
            t._sched.executor.close()
        durable = t.wal.durable_seqno if t.wal is not None else t._seqno
        if t.wal is not None:
            t.wal.simulate_power_loss()
        self._dead.add(idx)
        self._ack_floor[idx] = durable
        link = self.links.get(idx)
        if link is not None:
            link.alive = False

    def restore_follower(self, idx: int) -> LSMTree:
        """Process restart of a killed follower: restore its durable
        prefix from disk and resume shipping from its watermark (the
        retention log held everything past the frozen ack floor)."""
        if idx == self._leader_idx:
            raise ValueError("restore the leader via ReplicatedShard.restore")
        t = LSMTree.restore(self.cfg, _replica_dir(self.root, idx),
                            device=self.device)
        self.replicas[idx] = t
        self._dead.discard(idx)
        self._ack_floor.pop(idx, None)
        self.links[idx] = ReplicationLink(self.log, t, name=f"r{idx}")
        if self.auto_pump and self._leader_idx not in self._dead:
            self.pump()
        return t

    def resync_follower(self, idx: int) -> LSMTree:
        """Snapshot bootstrap: rebuild follower ``idx`` from the
        leader's durable state (a consistent spill-dir copy after a
        drain + WAL sync) and resume shipping.  The path a
        dropped-divergent or retention-expired replica takes back into
        the group."""
        if idx == self._leader_idx:
            raise ValueError("cannot resync the leader onto itself")
        old = self.replicas.get(idx)
        if old is not None and idx not in self._dead:
            if old._sched is not None and old._owns_sched:
                old._sched.executor.close()
        leader = self.leader
        leader.drain()
        leader.wal.sync()
        src = _replica_dir(self.root, self._leader_idx)
        dst = _replica_dir(self.root, idx)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        t = LSMTree.restore(self.cfg, dst, device=self.device)
        self.replicas[idx] = t
        self._dead.discard(idx)
        self._ack_floor.pop(idx, None)
        self.links[idx] = ReplicationLink(self.log, t, name=f"r{idx}")
        self.n_resyncs += 1
        return t

    # ------------------------------------------------------------------ #
    # failover
    # ------------------------------------------------------------------ #
    def promote(self, idx: int) -> int:
        """Fail over to follower ``idx`` (see module doc for the
        commit-point ordering).  Returns the new leader's watermark —
        the acked prefix the promoted replica serves."""
        if idx == self._leader_idx:
            return self.leader._seqno
        if idx in self._dead or idx not in self.replicas:
            raise ValueError(f"replica {idx} is not a live follower")
        old_idx = self._leader_idx
        old_alive = old_idx not in self._dead
        old = self.replicas[old_idx] if old_alive else None
        if old_alive:
            # planned failover: one last shipping round so the target
            # loses nothing the links would have delivered anyway
            self.pump()
        crashpoint("promote.before_seal")
        if old is not None and old.wal is not None:
            # fence the old epoch: a zombie leader's appends can no
            # longer enter the replication stream
            old.wal.tap = None
        new = self.replicas[idx]
        if new.wal is not None:
            new.wal.sync()   # applied == durable before taking leadership
        watermark = new._seqno
        self._persist_epoch(self.epoch + 1, idx, watermark)  # commit point
        crashpoint("promote.after_seal")
        self.log.truncate_above(watermark)
        crashpoint("promote.after_truncate")
        self.epoch += 1
        self._leader_idx = idx
        self.links.pop(idx, None)
        self._ack_floor.pop(idx, None)
        new.wal.tap = self.log.append
        if old_alive:
            if old._seqno <= watermark:
                # the demoted leader rejoins as a follower and catches
                # up from its watermark like any lagging replica
                self.links[old_idx] = ReplicationLink(
                    self.log, old, name=f"r{old_idx}")
            else:
                self._drop_divergent(old_idx)
        for i in list(self.links):
            if i in self._dead:
                continue
            if self.replicas[i]._seqno > watermark:
                # applied records the new epoch never acknowledged:
                # cannot be truncated in place once flushed — drop and
                # let resync_follower rebuild from the new leader
                self._drop_divergent(i)
        self.n_promotes += 1
        if self.auto_pump:
            self.pump()
        return watermark

    def _drop_divergent(self, idx: int) -> None:
        t = self.replicas[idx]
        if t._sched is not None and t._owns_sched:
            t._sched.executor.close()
        if t.wal is not None:
            t.wal.tap = None
        self._dead.add(idx)
        self.links.pop(idx, None)
        self._ack_floor.pop(idx, None)
        self.n_divergent_dropped += 1

    # ------------------------------------------------------------------ #
    # group restore (coordinator crash, e.g. mid-promote)
    # ------------------------------------------------------------------ #
    @classmethod
    def restore(cls, cfg: LSMConfig, root_dir: str,
                read_policy: Optional[ReadPolicy] = None,
                auto_pump: bool = True, device=None) -> "ReplicatedShard":
        """Rebuild a group from its root dir.  The EPOCH file names the
        authoritative leader — its atomic rename is the failover commit
        point, so a crash at any ``promote.*`` site resolves to exactly
        one epoch.  Every replica restores its durable prefix; followers
        not bit-aligned with the leader (behind: the in-memory retention
        log died with the process; ahead: a divergent unacked tail) are
        snapshot-resynced off the leader.  ``device`` is every restored
        replica's, as in ``__init__``."""
        obj = cls.__new__(cls)
        obj.cfg = cfg
        obj.root = root_dir
        obj.device = resolve_device(device)
        obj.read_policy = read_policy if read_policy is not None \
            else ReadPolicy()
        obj.auto_pump = auto_pump
        with open(os.path.join(root_dir, EPOCH_FILE)) as f:
            meta = json.load(f)
        obj.epoch = int(meta["epoch"])
        obj._leader_idx = int(meta["leader"])
        obj.log = ReplicationLog()
        obj.read_stats = StageStats()
        obj.n_promotes = 0
        obj.n_resyncs = 0
        obj.n_divergent_dropped = 0
        obj._rr = 0
        obj._dead = set()
        obj._ack_floor = {}
        obj.links = {}
        idxs = sorted(
            int(m.group(1)) for n in os.listdir(root_dir)
            if (m := _REPLICA_DIR_RE.fullmatch(n)))
        obj.replicas = {
            i: LSMTree.restore(cfg, _replica_dir(root_dir, i),
                               device=obj.device)
            for i in idxs}
        leader = obj.replicas[obj._leader_idx]
        obj.log.reset_floor(leader._seqno)
        leader.wal.tap = obj.log.append
        misaligned = []
        for i in idxs:
            if i == obj._leader_idx:
                continue
            t = obj.replicas[i]
            if t._seqno == leader._seqno:
                obj.links[i] = ReplicationLink(obj.log, t, name=f"r{i}")
            else:
                if t._seqno > leader._seqno:
                    obj.n_divergent_dropped += 1
                misaligned.append(i)
        for i in misaligned:
            obj._dead.add(i)   # resync replaces the restored tree
            obj.resync_follower(i)
        obj._persist_epoch(obj.epoch, obj._leader_idx, leader._seqno)
        return obj

    # ------------------------------------------------------------------ #
    # read routing (bounded staleness)
    # ------------------------------------------------------------------ #
    def _route(self) -> Tuple[int, LSMTree, int]:
        """Pick the serving replica under the read policy; returns
        (replica idx, tree, observed lag in seqnos)."""
        head = self.leader._seqno
        pol = self.read_policy
        eligible: List[Tuple[int, int]] = []
        if pol.prefer_follower:
            for i in self.links:
                if i in self._dead:
                    continue
                applied = self.replicas[i]._seqno
                if head - applied <= pol.max_lag_seqnos:
                    eligible.append((i, applied))
        c = self.read_stats.counts
        if not eligible:
            if self._leader_idx in self._dead:
                raise ReplicationLag(
                    "leader is dead and no follower satisfies "
                    f"max_lag_seqnos={pol.max_lag_seqnos}; promote first")
            c["leader_reads"] += 1
            return self._leader_idx, self.leader, 0
        top = max(s for _, s in eligible)
        best = sorted(i for i, s in eligible if s == top)
        pick = best[self._rr % len(best)]   # tie-break: capacity scaling
        self._rr += 1
        lag = head - top
        c["follower_reads"] += 1
        c["read_lag_total"] += lag
        c["read_lag_max"] = max(c["read_lag_max"], lag)
        return pick, self.replicas[pick], lag

    def snapshot(self) -> ReplicaSnapshot:
        idx, tree, lag = self._route()
        return ReplicaSnapshot(tree=tree, snap=tree.snapshot(),
                               replica=idx, lag=lag,
                               follower=idx != self._leader_idx)

    def _pin(self, snapshot: Optional[ReplicaSnapshot]) -> ReplicaSnapshot:
        return snapshot if snapshot is not None else self.snapshot()

    def get(self, key: int,
            snapshot: Optional[ReplicaSnapshot] = None) -> Optional[bytes]:
        s = self._pin(snapshot)
        return s.tree.get(key, snapshot=s.snap)

    def filter(self, pred: Predicate,
               snapshot: Optional[ReplicaSnapshot] = None) -> FilterResult:
        s = self._pin(snapshot)
        return s.tree.filter(pred, snapshot=s.snap)

    def filter_many(self, preds: List[Predicate],
                    snapshot: Optional[ReplicaSnapshot] = None
                    ) -> List[FilterResult]:
        s = self._pin(snapshot)
        return s.tree.filter_many(preds, snapshot=s.snap)

    def range_lookup(self, lo: int, hi: int,
                     snapshot: Optional[ReplicaSnapshot] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        s = self._pin(snapshot)
        return s.tree.range_lookup(lo, hi, snapshot=s.snap)

    def aggregate(self, spec, snapshot: Optional[ReplicaSnapshot] = None):
        s = self._pin(snapshot)
        return s.tree.aggregate(spec, snapshot=s.snap)

    def aggregate_many(self, specs,
                       snapshot: Optional[ReplicaSnapshot] = None):
        s = self._pin(snapshot)
        return s.tree.aggregate_many(specs, snapshot=s.snap)

    # ------------------------------------------------------------------ #
    # reporting + lifecycle
    # ------------------------------------------------------------------ #
    def replication_report(self) -> Dict[str, object]:
        head = self.leader._seqno
        return {
            "epoch": self.epoch,
            "leader": self._leader_idx,
            "head_seqno": head,
            "watermarks": {i: self.replicas[i]._seqno
                           for i in self.replicas},
            "durable": {i: (self.replicas[i].wal.durable_seqno
                            if self.replicas[i].wal else 0)
                        for i in self.replicas},
            "dead": sorted(self._dead),
            "log_retained": len(self.log),
            "log_floor": self.log.floor,
            "n_promotes": self.n_promotes,
            "n_resyncs": self.n_resyncs,
            "n_divergent_dropped": self.n_divergent_dropped,
            "links": {i: {"shipped": lk.shipped, "pumps": lk.pumps,
                          "blocked": lk.blocked_pumps,
                          "resumes": lk.resumes}
                      for i, lk in self.links.items()},
            "reads": dict(self.read_stats.counts),
        }

    def close(self) -> None:
        for i, t in self.replicas.items():
            if i not in self._dead:
                t.close()

    def __enter__(self) -> "ReplicatedShard":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
