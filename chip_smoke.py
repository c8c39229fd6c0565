#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: one card, ~8.4 M pairs

Phases, each printing JSON lines:

1. build:   nvcc builds the twelve CUDA kernels from ``src/repro_torch``;
            prints build seconds, the card (nvidia-smi), torch and CUDA.
2. main:    the port's main path through ``LSMTree`` at the paper's
            section 5.1 shapes (16-byte keys, 256-byte values from a
            vocabulary of NDV ratio 0.01, uniform; 32 MiB files, T=10,
            L0 limit 4): put_batch ingest with inline flushes and
            compactions, deletes, one filter_many of K=16 predicates and a
            batch of gets; then a clustered phase (key-correlated values)
            where zone maps let the filter kernel skip tiles.  Results are
            held against a plain host reference written here (numpy
            last-write-wins + byte compares), independent of the port.
            Kernel launch counts are reset just before and read just
            after; each of the four kernels of that path must have launched.
3. serve:   the main tree with its filter backend switched by configuration
            (the write path does not depend on it).  serve.jax_packed: a
            ``ScanServer`` (max_batch 16) fed the 16 predicates interleaved
            with 2 selective aggregates; serve.jax: the 16 predicates through
            ``filter_many`` on the same snapshot, also equal to the 'fused'
            answers; serve.numpy: the same under 'numpy' (the codes unpacked
            and compared on the host), also equal to 'fused'.  Answers are
            held against the plain host model.  Each phase resets the launch
            counts just before its checked call and reads them just after:
            serve.jax_packed must have launched multi_range_filter_packed,
            serve.jax range_filter_codes and unpack_codes, neither the fused
            filter, and serve.numpy no kernel at all.  serve.turns: the four
            filter backends' ``filter_many`` in turns on the warm main and
            clustered trees, each answer equal to 'fused'.
4. agg:     the analytics path through ``LSMTree.aggregate_many`` (COUNT,
            SUM, MIN/MAX, GROUP BY prefix with top-k and by 16 buckets):
            agg.general on the main tree (overlapping levels: the fused
            filter and the host visibility merge), agg.fast on a new tree
            of the main configuration loaded with sequential keys and
            compacted (the fast path: fused_zone_agg and zone_histogram),
            agg.clustered on the clustered tree (tiles skipped and taken in
            closed form).  Answers, bucket edges included, are held
            against the plain host model.  Each phase resets the launch
            counts just before its checked ``aggregate_many`` and reads
            them just after: agg.general must have launched the fused
            filter, agg.fast and agg.clustered both aggregate kernels.
5. compact: the main phase's write stream replayed into a tree under
            each other compaction backend: compact.jax (the remap_codes
            kernel) and compact.numpy (the remap on the host).  Every SCT of
            every level must equal the main ('jax_packed') tree's, and
            filter_many (K=16) the host model.  Each phase resets the launch
            counts before its ingest and reads them after its filter:
            compact.jax must have launched remap_codes, unpack_codes and
            pack_codes, compact.numpy not remap_codes, and neither
            remap_pack_codes.
6. range:   main.range: ``range_lookup`` on the main tree over 8 windows of
            1/64 of the key space (one on a snapshot pinned before a few
            overwrites), an empty and an inverted window, each held key for
            key and byte for byte against the host model; host code, no
            kernel launches.
7. fig5:    the paper's Figure-5 pipeline (``examples/filter_analytics.py``)
            on every SCT of the main tree for its 16 predicates: numpy on
            the host-unpacked codes, range_filter_codes on the code column
            and range_filter_packed on the packed words, all equal to each
            other and to the host model; it must launch range_filter_packed.
            fig5.example: the example itself on the port at its own
            configuration (200,000 puts, 128-byte values, 1 MiB files,
            'numpy' backends), through filter, filter_many (K=16) and a
            ScanServer (max_batch 8), every answer held against the host
            model.
8. codecs:  one seeded stream (the main phase's generator at 2^20 pairs
            and 2,048 deletes, ``--codec-pairs``) into a tree of the main
            configuration for each of the harness's five systems: 'opd',
            'plain', 'heavy', 'blob' and 'blob' with blob_compress
            (codecs.blob_zstd), the paper's baselines beside its design:
            filter_many (K=16) and aggregate_many (the agg phase's 6 specs)
            under 'fused' and under 'numpy', range_lookup over 8 windows
            and get of 1,024 keys (768 present, 128 deleted, 128 missing;
            'blob_zstd', whose every read decompresses a whole log, reads
            the first 48, 8 and 8 of them and is compared with 'opd' at
            those 64).
            The five trees must give the same answers, each equal to the
            host model; one line per codec carries ingest seconds and
            ops/s, compaction, filter and aggregate stage seconds ('decode'
            included), the range_lookup median, disk bytes per level, blob
            GC counters and logs, and the launch counts of its window,
            which must be 0 for the four competitors.  Then each blob tree
            takes a snapshot and a burst overwriting most live keys twice
            (codecs.<codec>.burst): compaction and GC run while the
            snapshot pins its logs, filter_many and the 1,024 gets at the
            snapshot return the answers from before the burst, current
            reads the burst's values (128 gets; 'blob_zstd' its 64), and
            once the snapshot is released the next GC pass leaves no log
            past the threshold.  codecs.done gives the phase's wall
            seconds.
9. durable: the main configuration with wal_sync='group' and a spill
            directory, the main phase's generator at 2^20 pairs and 2,048
            deletes (``--durable-pairs``): the crash point
            compact.before_manifest armed, the stream ingested until it
            fires, the WAL's unsynced tail dropped
            (``simulate_power_loss``) and the tree abandoned;
            ``LSMTree.restore`` on the card must recover a seqno K between
            the WAL's durable floor and the mutations issued and answer
            filter_many (K=16), range_lookup over 8 windows, get of the
            codec probe's 1,024 keys and aggregate_many (6 specs) as the
            host model of the first K mutations; then the rest of the
            stream, the same reads against the whole model, and a planned
            ``close`` and second restore after which every SCT equals its
            counterpart (torch.equal on the packed words) and every answer
            the one before.  The window from the first restore to the end
            of the ingest must launch fused_zone_filter, unpack_codes,
            remap_pack_codes and pack_codes.  durable.done carries the
            WAL's appends, syncs and bytes, the spill files and bytes,
            the restores' seconds by stage (store, manifest, build,
            wal_replay), ingest ops/s with the WAL on and io_report under
            the three device models.
10. background: the main configuration with maintenance='background',
            the main phase's generator at 2^20 pairs and 2,048 deletes
            (``--background-pairs``): put_batch in calls of 2^16 pairs while
            the flush and compaction workers launch pack_codes,
            unpack_codes and remap_pack_codes off the writer's thread and
            a reader thread, from the first flushed run on, drives a
            ScanServer(maintenance='background') in batches of the 16
            predicates and 2 selective aggregates, each on its own
            snapshot and checked against the stream written so far (keys
            sorted and unique, values satisfying their predicates, every
            pair one the stream wrote, and every scan and aggregate equal
            to the host model of the stream's first snapshot-seqno
            mutations); each batch records whether a flush or compaction
            job was in flight at its start and end, and the reader's
            fused_zone_filter must launch at least once while one is.
            After
            drain(): filter_many (K=16), 8 range_lookup windows, 1,024
            gets and the 6 aggregate specs equal to the host model, and one
            ScanServer(maintenance='sync') batch too; at least one flush
            and one compaction ran on the workers.  The launch counts are
            reset before the ingest and read after drain(), so the
            workers' launches fall inside the window: pack_codes,
            unpack_codes, remap_pack_codes and fused_zone_filter must each
            have launched.  background.done carries ingest seconds and
            ops/s, the workers' flushes and compactions, the throttle's
            slowdowns and stalls, the reader's batches with their median
            wall seconds and queue wait, the launches, and the codecs
            phase's 'opd' ingest (the same configuration in sync mode)
            beside them.
11. bench:   the kernel micro-bench's entry points
            (``benchmarks/bench_kernels.py``): range_filter_packed on 2^20
            codes at widths 8 and 16, bloom_probe on a 2^14-bit bloom and
            on the largest documented one (2,048 words, 2^20 keys, no false
            negative), ssm_scan at falcon-mamba-7b's width (d_inner 8192,
            d_state 16, 2,048 tokens), held against host models.
12. kernels: each kernel against its plain PyTorch version on the card, on
            operands recorded from the main path, the serve phases,
            agg.fast, compact.jax and fig5, and at bench's shapes
            (bit-identical required; ssm_scan within rtol = atol = 1e-4),
            with CUDA-event medians, the plain version's time and the bound:
            the larger of the bytes over the card's data-sheet bandwidth
            and, for range_filter_packed, bloom_probe and ssm_scan, the
            operations over the card's integer, float32 or exp rate.
            pack_codes and unpack_codes have one row per pack width the
            main path packed (unpacked), with that width's launches
            (main.pack_by_width, main.unpack_by_width; remap_pack_codes'
            in main.remap_by_width), and pack_codes one at compact.jax's
            largest pack (a width-32 merge output) and at width 16 on the
            same codes; at width 32 the pack and the unpack sit beside
            codes.clone() and words[:n].clone() (the same functions there);
            remap_codes and fused_zone_agg with SUM carry their gathers' L2
            sector bytes.  These four kernels, fused_zone_agg,
            zone_histogram, the four filters, bloom_probe and ssm_scan
            are also timed in CUDA graphs with their operands in L2
            (graph_ms) and from device memory (cold_graph_ms), both remaps
            with every entry dead (streams_only_cold_graph_ms: no gather),
            and the width-32 unpack and clone at 8 times its n
            (cold_graph_ms_8n, library_cold_graph_ms_8n).  ssm_scan is also
            timed cold at state dimensions 1, 8 and 32 on the same u and
            delta (state_dim_cold_graph_ms), and fused_zone_agg cold at K
            = 1 and 2 on the same tiles in its 1- and 2-slot
            instantiations and in its 8-slot one (slots_cold_graph_ms);
            zone_histogram cold in both bin buckets at 16 and 64 bins
            (buckets_cold_graph_ms), bloom_probe cold at the largest
            prime below its nbits (odd_nbits_cold_graph_ms), both with
            the SASS instructions per code or key of their hot loop
            (cuobjdump -sass).  range_filter_codes and
            range_filter_packed are timed in CUDA graphs at each cluster
            size the build instantiates (4 and 8 blocks a tile; their
            grids are tiles x cluster), cold on the input padded to whole
            tiles, beside a copy of the same traffic cold (codes.to(
            torch.int8), words.clone()), and through their ops entry
            point cold on the input as it is and with the pad copy that
            entry point made before.  Their rows
            carry the registers, shared memory and spills of every
            instantiation of their kernel at that width, from the build's
            -Xptxas=-v log.

A ``total`` line gives the run's wall seconds.  The last three lines are
the card (nvidia-smi name, power limit), the kernel table ``{"kernels": [...]}`` and ``{"ok": true, "device": ...}``.
Any mismatch or error exits non-zero before them.  The script imports
only torch, numpy and the port; it exits non-zero with no result when no
CUDA card is available or when it stands outside the repository.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# device-memory bandwidth (bytes/s) from NVIDIA's data sheets, by card name
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
# float32 rate outside the tensor cores (FLOP/s), from the same data sheets
FP32_RATE = (("H100 PCIe", 51.2e12), ("H200", 67e12), ("H100", 67e12))
# results per clock per SM on compute capability 9.0 (the CUDA C++
# Programming Guide's arithmetic throughput table): exp2 (expf costs one)
# and 32-bit integer add, multiply, shift and logic
EXP_PER_CLOCK_PER_SM = 16
INT32_PER_CLOCK_PER_SM = 64

KERNELS = {
    "pack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                   "src/repro/kernels/bitpack.py:57"),
    "unpack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                     "src/repro/kernels/bitpack.py:75"),
    "fused_zone_filter": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                          "src/repro/kernels/fused_scan.py:115"),
    "remap_pack_codes": ("src/repro_torch/kernels/csrc/merge_remap.cu",
                         "src/repro/kernels/merge_remap.py:141"),
    "fused_zone_agg": ("src/repro_torch/kernels/csrc/agg_scan.cu",
                       "src/repro/kernels/agg_scan.py:228"),
    "zone_histogram": ("src/repro_torch/kernels/csrc/agg_scan.cu",
                       "src/repro/kernels/agg_scan.py:344"),
    "multi_range_filter_packed": ("src/repro_torch/kernels/csrc/multi_filter.cu",
                                  "src/repro/kernels/multi_filter.py:77"),
    "range_filter_codes": ("src/repro_torch/kernels/csrc/opd_filter.cu",
                           "src/repro/kernels/opd_filter.py:49"),
    "remap_codes": ("src/repro_torch/kernels/csrc/merge_remap.cu",
                    "src/repro/kernels/merge_remap.py:109"),
    "range_filter_packed": ("src/repro_torch/kernels/csrc/packed_filter.cu",
                            "src/repro/kernels/packed_filter.py:63"),
    "bloom_probe": ("src/repro_torch/kernels/csrc/bloom_probe.cu",
                    "src/repro/kernels/bloom_probe.py:73"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:83"),
}
MAIN_KERNELS = ("pack_codes", "unpack_codes", "fused_zone_filter",
                "remap_pack_codes")
AGG_KERNELS = ("fused_zone_agg", "zone_histogram")
SYMBOLS = {"pack_codes": "pack_codes_kernel",
           "unpack_codes": "unpack_codes_kernel",
           "fused_zone_filter": "fused_zone_filter_kernel",
           "remap_pack_codes": "remap_pack_codes_kernel",
           "fused_zone_agg": "fused_zone_agg_kernel",
           "zone_histogram": "zone_histogram_kernel",
           "multi_range_filter_packed": "multi_range_filter_kernel",
           "range_filter_codes": "range_filter_codes_kernel",
           "remap_codes": "remap_codes_kernel",
           "range_filter_packed": "range_filter_packed_kernel",
           "bloom_probe": "bloom_probe_kernel",
           "ssm_scan": "ssm_scan_kernel"}
INT32_MAX = 2**31 - 1
NO_LIBRARY = ("no single PyTorch call computes this bit-field function; "
              "its plain version is several calls")
LIBRARY_WHY = {"range_filter_codes": (
    "no single PyTorch call gives the range mask with per-tile counts; its "
    "plain version is four calls"), "remap_codes": (
    "no single PyTorch call computes a gather with -1 kept at dead entries "
    "and per-source offsets; its plain version is several calls"),
    "bloom_probe": (
        "no single PyTorch call hashes keys and tests their bloom bits; its "
        "plain version is several calls per hash"),
    "ssm_scan": (
        "no single PyTorch call computes a selective scan (sequential in L); "
        "its plain version is several calls per time step")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------- #
# workload (paper section 5.1 as benchmarks/_harness.py encodes it)
# --------------------------------------------------------------------------- #
def make_vocab(ndv: int, width: int, rng) -> np.ndarray:
    """ndv distinct width-byte values 'cat_%05d_' + random letters."""
    fill = rng.integers(97, 123, (ndv, width - 10)).astype(np.uint8)
    out = np.zeros((ndv, width), np.uint8)
    for i in range(ndv):
        out[i, :10] = np.frombuffer(b"cat_%05d_" % (i % 1000), np.uint8)
    out[:, 10:] = fill
    vocab = out.view(f"S{width}").reshape(-1)
    check(np.unique(vocab).shape[0] == ndv, "vocabulary values collide")
    return vocab


def matches(value: bytes, kind: str, a: bytes, b: bytes) -> bool:
    """Plain predicate semantics over NUL-stripped bytes."""
    v = value.rstrip(b"\x00")
    if kind == "eq":
        return v == a
    if kind == "prefix":
        return v.startswith(a)
    if kind == "range":
        return a <= v <= b
    if kind == "ge":
        return v >= a
    if kind == "le":
        return v <= b
    raise ValueError(kind)


class Reference:
    """Plain host model of the tree over a value vocabulary: operations in
    order, the last write to a key wins, a delete removes the key."""

    def __init__(self, vocab: np.ndarray) -> None:
        self.vocab = vocab
        self.ops = []   # (keys uint64, vocabulary index; -1 = delete)
        self.live = None

    def put(self, keys: np.ndarray, idx: np.ndarray) -> None:
        self.ops.append((np.asarray(keys, np.uint64), np.asarray(idx, np.int64)))
        self.live = None

    def delete(self, keys) -> None:
        keys = np.asarray(keys, np.uint64)
        self.ops.append((keys, np.full(keys.shape[0], -1, np.int64)))
        self.live = None

    def state(self):
        """(keys sorted, vocabulary index) of the live keys."""
        if self.live is None:
            keys = np.concatenate([k for k, _ in self.ops])
            idx = np.concatenate([i for _, i in self.ops])
            # last occurrence of each key: unique over the reversed stream
            uk, first = np.unique(keys[::-1], return_index=True)
            last = idx[keys.shape[0] - 1 - first]
            keep = last >= 0
            self.live = (uk[keep], last[keep])
        return self.live

    def filter(self, kind: str, a: bytes, b: bytes):
        keys, idx = self.state()
        hit = np.asarray([matches(bytes(v), kind, a, b) for v in self.vocab],
                         bool)
        sel = hit[idx]
        return keys[sel], self.vocab[idx[sel]]

    def get(self, key: int):
        keys, idx = self.state()
        i = int(np.searchsorted(keys, np.uint64(key)))
        if i < keys.shape[0] and keys[i] == np.uint64(key):
            return bytes(self.vocab[idx[i]])
        return None


def run_filter_check(tree, ref: Reference, preds, label: str) -> dict:
    import torch
    from repro_torch import Predicate

    tp = [Predicate(kind, a, b) for kind, a, b in preds]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tree.filter_many(tp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_match = check_filters(got, ref, preds, label)
    return {"filter_many_s": dt, "k": len(preds), "rows_matched": n_match}


def check_filters(got, ref: Reference, preds, label: str) -> int:
    """Hold each ``FilterResult`` against the host model; returns the rows
    matched."""
    n_match = 0
    for (kind, a, b), r in zip(preds, got):
        keys, vals = ref.filter(kind, a, b)
        check(np.array_equal(r.keys, keys),
              f"{label}: filter {kind} {a!r} {b!r} keys differ "
              f"({r.keys.shape[0]} vs {keys.shape[0]})")
        check(r.values.tolist() == vals.tolist(),
              f"{label}: filter {kind} {a!r} values differ")
        n_match += int(keys.shape[0])
    return n_match


def run_get_check(tree, ref: Reference, keys: np.ndarray, label: str) -> dict:
    t0 = time.perf_counter()
    for k in keys.tolist():
        want = ref.get(k)
        got = tree.get(k)
        check(got == want,
              f"{label}: get({k}) = {got!r}, expected {want!r}")
    return {"gets": int(keys.shape[0]),
            "get_us": (time.perf_counter() - t0) / max(1, keys.shape[0]) * 1e6}


def main_config():
    """The main phase's configuration: the paper's section 5.1 shapes."""
    from repro_torch import LSMConfig

    return LSMConfig(key_bytes=16, value_width=256, file_bytes=32 * 2**20,
                     size_ratio=10, l0_limit=4)


def make_stream(rng, n: int, width: int) -> tuple:
    """(keys, vocabulary, vocabulary index per put, deleted keys): n puts
    of width-byte values uniform over NDV ratio 0.01, keys uniform over
    [0, 4 n), then n / 512 deletes of written keys."""
    ndv = max(1, int(n * 0.01))
    vocab = make_vocab(ndv, width, rng)
    keys = rng.integers(0, 4 * n, n, dtype=np.uint64)
    vidx = rng.integers(0, ndv, n)
    dels = rng.choice(keys, max(1, n // 512), replace=False)
    return keys, vocab, vidx, dels


def make_preds(vocab: np.ndarray) -> list:
    """The 16 filter predicates over a ``make_vocab`` vocabulary."""
    preds = [("prefix", b"cat_%05d_" % (37 * i + 5), b"") for i in range(11)]
    preds += [("range", b"cat_00100_", b"cat_00104_\xff"),
              ("eq", bytes(vocab[vocab.shape[0] // 2]).rstrip(b"\x00"), b""),
              ("ge", b"cat_00996_", b""), ("le", b"", b"cat_00002_\xff"),
              ("prefix", b"zzz", b"")]
    return preds


def main_phase(args, device: str):
    """Uniform phase then clustered phase; returns the launch counts and
    the trees with their host models for the analytics phases."""
    import torch
    from repro_torch import LSMTree, Predicate
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed)
    n, cfg = args.pairs, main_config()
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    ndv = vocab.shape[0]
    emit({"phase": "main", "reduced": "pairs 6.4e7 -> %.1e (host-side memtable "
          "ingest within the smoke's time limit)" % n, "pairs": n,
          "value_width": cfg.value_width, "ndv": ndv,
          "file_bytes": cfg.file_bytes})

    ops.reset_launches()
    tree = LSMTree(cfg, device=device)
    ingest_s = ingest(tree, stream)
    ref = Reference(vocab)
    ref.put(keys, vidx)
    ref.delete(dels)
    emit({"phase": "main.ingest", **ingest_report(tree, stream, ingest_s)})

    preds = make_preds(vocab)
    res = run_filter_check(tree, ref, preds, "main")
    res["filter_stages_s"] = dict(tree.filter_stats.seconds)
    c = tree.filter_stats.counts
    res.update({k: c[k] for k in ("fused_launches", "zone_tiles_total",
                                  "zone_tiles_skipped", "zone_blocks_total",
                                  "zone_blocks_skipped")})
    # the same batch again under the profiler: the card's busy time
    res.update(device_busy(lambda: tree.filter_many(
        [Predicate(kind, a, b) for kind, a, b in preds])))
    emit({"phase": "main.filter", **res})
    probe = np.concatenate([rng.choice(keys, 1536), dels[:256],
                            rng.integers(4 * n, 8 * n, 256, dtype=np.uint64)])
    emit({"phase": "main.get", **run_get_check(tree, ref, probe, "main")})

    # clustered phase: values follow keys, so zone maps prune tiles
    n2 = args.clustered_pairs
    ck = np.arange(n2, dtype=np.uint64)
    cv = np.char.add(b"ts_", np.char.zfill(
        (ck // 4).astype(np.int64).astype("S12"), 12)).astype(f"S{cfg.value_width}")
    ctree = LSMTree(cfg, device=device)
    cvocab, cidx = np.unique(cv, return_inverse=True)
    cref = Reference(cvocab)
    t0 = time.perf_counter()
    ctree.put_batch(ck, cv)
    cref.put(ck, cidx.reshape(-1))
    ctree.compact()
    torch.cuda.synchronize()
    cingest = time.perf_counter() - t0
    cpreds = [("range", b"ts_%012d" % lo, b"ts_%012d" % (lo + 5))
              for lo in ((i * 997) % max(1, n2 // 8) for i in range(16))]
    cres = run_filter_check(ctree, cref, cpreds, "clustered")
    cc = ctree.filter_stats.counts
    cres.update({k: cc[k] for k in ("fused_launches", "zone_tiles_total",
                                    "zone_tiles_skipped", "zone_blocks_total",
                                    "zone_blocks_skipped")})
    check(cc["zone_tiles_skipped"] > 0, "clustered phase skipped no tile")
    emit({"phase": "clustered", "pairs": n2, "ingest_s": cingest,
          "levels": ctree.shape_report()["levels"], **cres})

    launches = dict(ops.LAUNCHES)
    emit({"phase": "main.launches", **launches})
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
    return launches, {"cfg": cfg, "tree": tree, "ref": ref, "vocab": vocab,
                      "preds": preds, "ctree": ctree, "cref": cref,
                      "cpreds": cpreds, "stream": stream}


def ingest(tree, stream) -> float:
    """The main phase's write stream into ``tree``: puts in batches of 2^20,
    then the deletes; returns the seconds (ending in a synchronize)."""
    import torch

    keys, vocab, vidx, dels = stream
    t0 = time.perf_counter()
    batch = 1 << 20
    for i in range(0, keys.shape[0], batch):
        tree.put_batch(keys[i:i + batch], vocab[vidx[i:i + batch]])
    for k in dels.tolist():
        tree.delete(k)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ingest_report(tree, stream, seconds: float) -> dict:
    n_ops = stream[0].shape[0] + stream[3].shape[0]
    shape = tree.shape_report()
    return {"ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
            "flush_s": tree.flush_stats.total(),
            "compaction_s": tree.compaction_stats.total(),
            "compaction_stages_s": dict(tree.compaction_stats.seconds),
            "n_flushes": shape["n_flushes"],
            "n_compactions": shape["n_compactions"],
            "levels": shape["levels"],
            "pack_widths": sorted({s.code_bits for s in tree.all_runs()}),
            "dict_sizes": sorted({s.opd.size for s in tree.all_runs()})[-3:],
            "disk_bytes": shape["disk_bytes"]}


# --------------------------------------------------------------------------- #
# serving path: the batched scan server on the staged filter backends
# --------------------------------------------------------------------------- #
# selective aggregates: the general path's host merge sees few candidates
SERVE_AGGS = [
    ("count", ("prefix", b"cat_00042_", b""), None, None),
    ("sum", ("range", b"cat_00100_", b"cat_00101_\xff"), None, None),
]


def serve_phase(state, recs) -> dict:
    """serve.jax_packed, serve.jax and serve.numpy on the main tree, its
    filter backend switched by configuration (the write path does not
    depend on it); returns each phase's launch counts by the kernel it
    exercises."""
    import dataclasses

    import torch
    from repro_torch import Predicate, ScanServer

    tree, ref, preds = state["tree"], state["ref"], state["preds"]
    fused_cfg = tree.cfg
    snap = tree.snapshot()
    for r in recs.values():
        r.active = True

    # serve.jax_packed: the server, 16 scans interleaved with 2 aggregates
    tree.cfg = dataclasses.replace(fused_cfg, filter_backend="jax_packed")
    srv = ScanServer(tree, max_batch=16)
    specs = make_specs(SERVE_AGGS)
    rids = srv.submit_many([Predicate(*p) for p in preds[:8]])
    agg_rids = [srv.submit_agg(specs[0])]
    rids += srv.submit_many([Predicate(*p) for p in preds[8:]])
    agg_rids.append(srv.submit_agg(specs[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, packed_launches = launch_window(srv.drain)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(packed_launches["multi_range_filter_packed"] > 0,
          "serve.jax_packed: multi_range_filter_packed never launched")
    check(packed_launches["fused_zone_filter"] == 0,
          "serve.jax_packed: the fused filter launched")
    n_match = check_filters([out[r] for r in rids], ref, preds,
                            "serve.jax_packed")
    check_aggs([out[r] for r in agg_rids], state["vocab"], ref.state()[1],
               SERVE_AGGS, "serve.jax_packed")
    st = srv.stats
    emit({"phase": "serve.jax_packed", "requests": st.n_served,
          "scans": len(rids), "aggregates": len(agg_rids),
          "batches": st.n_batches, "batch_sizes": st.batch_sizes,
          "mean_batch": st.mean_batch, "wall_s": wall,
          "wall_s_per_batch": wall / st.n_batches,
          "wait_s_median": statistics.median(st.wait_seconds),
          "rows_matched": n_match, "launches": packed_launches,
          **device_busy(lambda: tree.filter_many(
              [Predicate(*p) for p in preds], snapshot=snap))})

    # serve.jax: the same scans through filter_many on the same snapshot,
    # equal to the host model and to the 'fused' answers
    tp = [Predicate(*p) for p in preds]
    tree.cfg = dataclasses.replace(fused_cfg, filter_backend="jax")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged, codes_launches = launch_window(
        lambda: tree.filter_many(tp, snapshot=snap))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in recs.values():
        r.active = False
    for name in ("range_filter_codes", "unpack_codes"):
        check(codes_launches[name] > 0, f"serve.jax: {name} never launched")
    check(codes_launches["fused_zone_filter"] == 0,
          "serve.jax: the fused filter launched")
    n_match = check_filters(staged, ref, preds, "serve.jax")
    tree.cfg = fused_cfg
    fused = tree.filter_many(tp, snapshot=snap)
    for p, a, b in zip(preds, staged, fused):
        check(np.array_equal(a.keys, b.keys) and
              a.values.tolist() == b.values.tolist(),
              f"serve.jax: {p} differs from the fused backend")
    emit({"phase": "serve.jax", "filter_many_s": dt, "k": len(preds),
          "rows_matched": n_match, "launches": codes_launches,
          "equal_to_fused": True})

    # serve.numpy: the same scans on the host (the reference's default
    # backend): each SCT's packed words come to the host once, no kernel
    tree.cfg = dataclasses.replace(fused_cfg, filter_backend="numpy")
    before = dict(tree.filter_stats.seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, host_launches = launch_window(
        lambda: tree.filter_many(tp, snapshot=snap))
    dt = time.perf_counter() - t0
    tree.cfg = fused_cfg
    check(sum(host_launches.values()) == 0,
          f"serve.numpy: kernels launched {host_launches}")
    n_match = check_filters(host, ref, preds, "serve.numpy")
    for p, a, b in zip(preds, host, fused):
        check(np.array_equal(a.keys, b.keys) and
              a.values.tolist() == b.values.tolist(),
              f"serve.numpy: {p} differs from the fused backend")
    emit({"phase": "serve.numpy", "filter_many_s": dt, "k": len(preds),
          "rows_matched": n_match, "launches": host_launches,
          "stages_s": {k: v - before.get(k, 0.0)
                       for k, v in tree.filter_stats.seconds.items()},
          "equal_to_fused": True})
    emit({"phase": "serve.turns", **backend_turns(state)})
    return {"multi_range_filter_packed":
            packed_launches["multi_range_filter_packed"],
            "range_filter_codes": codes_launches["range_filter_codes"]}


FILTER_BACKENDS = ("fused", "jax_packed", "jax", "numpy")


def backend_turns(state) -> dict:
    """``filter_many`` under each filter backend in turns (A B C D D C B A
    A B C D) on the warm main and clustered trees, one snapshot each; every
    answer must equal the turn's first ('fused', held against the host
    model by main.filter and clustered).  Returns the wall seconds per
    backend and their medians."""
    import dataclasses

    import torch
    from repro_torch import Predicate

    order = FILTER_BACKENDS + FILTER_BACKENDS[::-1] + FILTER_BACKENDS
    out = {"order": order}
    for label, tree, preds in (("main", state["tree"], state["preds"]),
                               ("clustered", state["ctree"],
                                state["cpreds"])):
        tp = [Predicate(*p) for p in preds]
        snap, base = tree.snapshot(), tree.cfg
        secs = {b: [] for b in FILTER_BACKENDS}
        first = None
        for b in order:
            tree.cfg = dataclasses.replace(base, filter_backend=b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tree.filter_many(tp, snapshot=snap)
            torch.cuda.synchronize()
            secs[b].append(time.perf_counter() - t0)
            first = first or got
            for p, x, y in zip(preds, got, first):
                check(np.array_equal(x.keys, y.keys) and
                      x.values.tolist() == y.values.tolist(),
                      f"serve.turns: {label} {b} {p} differs from 'fused'")
        tree.cfg = base
        out[label] = {"filter_many_s": secs, "median_s": {
            b: statistics.median(v) for b, v in secs.items()}}
    return out


# --------------------------------------------------------------------------- #
# analytics path: aggregates held against the plain host model
# --------------------------------------------------------------------------- #
# (op, predicate (kind, a, b) or None, group ("prefix", len) or ("bucket", n)
# or None, top_k)
AGG_TABLE = [
    ("count", ("prefix", b"cat_00042_", b""), None, None),
    ("sum", ("range", b"cat_00100_", b"cat_00199_\xff"), None, None),
    ("min", None, None, None),
    ("max", None, None, None),
    ("group_count", None, ("prefix", 7), 5),
    ("group_count", None, ("bucket", 16), None),
]


def numeric(value: bytes) -> int:
    """SUM weight of a value: its first run of ASCII digits as an integer,
    clipped to int32 max; no digit -> 0."""
    m = re.search(rb"[0-9]+", value)
    return min(int(m.group()), INT32_MAX) if m else 0


def vocab_hits(vocab: np.ndarray, pred) -> np.ndarray:
    """Which vocabulary values a predicate matches (numpy byte compares;
    values hold no NUL, so NUL padding orders as the shorter string)."""
    if pred is None:
        return np.ones(vocab.shape[0], bool)
    kind, a, b = pred
    lo, hi = (np.asarray([x], vocab.dtype)[0] for x in (a, b))
    return {"eq": lambda: vocab == lo,
            "prefix": lambda: np.char.startswith(vocab, a),
            "range": lambda: (vocab >= lo) & (vocab <= hi),
            "ge": lambda: vocab >= lo,
            "le": lambda: vocab <= hi}[kind]()


def equi_depth_edges(domain: np.ndarray, n_buckets: int) -> tuple:
    """Interior edges of n equi-depth buckets over a sorted unique domain."""
    d = domain.shape[0]
    idx = np.unique((np.arange(1, n_buckets) * d) // n_buckets)
    idx = idx[(idx > 0) & (idx < d)]
    return tuple(bytes(v) for v in np.unique(domain[idx]))


def expected_groups(vocab, sel, group, edges, top_k):
    """Sorted (label, count) groups of the rows with vocabulary indices
    ``sel``: by value prefix, or by bucket (#(edges <= value))."""
    if group[0] == "prefix":
        labels = np.asarray([bytes(v)[:group[1]] for v in vocab], object)
    else:
        cut = np.searchsorted(np.asarray(edges, vocab.dtype), vocab,
                              side="right")
        names = [b""] + list(edges)
        labels = np.asarray([names[c] for c in cut], object)
    uniq, inv = np.unique(labels, return_inverse=True)
    counts = np.bincount(inv[sel], minlength=uniq.shape[0])
    items = sorted(((bytes(uniq[i]), int(c)) for i, c in enumerate(counts)
                    if c), key=lambda kv: (-kv[1], kv[0]))
    return items[:top_k] if top_k is not None else items


def make_specs(table) -> list:
    from repro_torch import AggSpec, GroupBy, Predicate

    specs = []
    for op, pred, group, top_k in table:
        g = None
        if group is not None:
            g = (GroupBy("prefix", prefix_len=group[1]) if group[0] == "prefix"
                 else GroupBy("bucket", n_buckets=group[1]))
        specs.append(AggSpec(op, Predicate(*pred) if pred else None, g, top_k))
    return specs


def run_agg_check(tree, vocab, idx, table, label, domain=None) -> dict:
    """One ``aggregate_many`` of ``table`` against the live rows (vocabulary
    indices ``idx``): counts, sums, min/max values and group lists must
    equal the host model's.  Bucket edges are equi-depth over ``domain``
    (``pinned_domain``); without one they are read back from the result's
    labels, and only the counts are checked under them."""
    import torch

    specs = make_specs(table)
    before = dict(tree.agg_stats.seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tree.aggregate_many(specs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0)
              for k, v in tree.agg_stats.seconds.items()}
    check_aggs(got, vocab, idx, table, label, domain)
    return {"aggregate_many_s": dt, "specs": len(specs), "stages_s": stages}


def check_aggs(got, vocab, idx, table, label, domain=None) -> None:
    """Hold each aggregate of ``table`` against the live rows (vocabulary
    indices ``idx``) of the host model."""
    weights = np.asarray([numeric(bytes(v)) for v in vocab], np.int64)
    rank = np.empty(vocab.shape[0], np.int64)
    rank[np.argsort(vocab)] = np.arange(vocab.shape[0])
    for (op, pred, group, top_k), r in zip(table, got):
        sel = idx[vocab_hits(vocab, pred)[idx]]
        what = f"{label}: {op} {pred} {group}"
        check(r.count == sel.shape[0],
              f"{what}: count {r.count} != {sel.shape[0]}")
        if op == "sum":
            want = int(weights[sel].sum())
            check(r.total == want, f"{what}: sum {r.total} != {want}")
        if op in ("min", "max"):
            want = ((bytes(vocab[sel[np.argmin(rank[sel])]]),
                     bytes(vocab[sel[np.argmax(rank[sel])]]))
                    if sel.shape[0] else (None, None))
            check((r.min_value, r.max_value) == want,
                  f"{what}: min/max {r.min_value!r}/{r.max_value!r}")
        if op == "group_count":
            edges = ()
            if group[0] == "bucket":
                edges = (equi_depth_edges(domain, group[1])
                         if domain is not None else
                         tuple(sorted(lab for lab, _ in r.groups if lab)))
                check(len(edges) < group[1], f"{what}: {len(edges)} edges")
            want = expected_groups(vocab, sel, group, edges, top_k)
            check(r.groups == want, f"{what}: groups differ")


def pinned_domain(ref: Reference):
    """The bucket domain of a tree built from ``ref``'s operations, or None
    where the host model cannot pin it.  The port's domain is the union of
    the runs' dictionaries and the memtable's newest live values: it holds
    every live row's value and nothing that was never written.  Where every
    written value still has a live row, both sides are the same set."""
    written = np.unique(np.concatenate([i for _, i in ref.ops]))
    written = written[written >= 0]
    live = np.unique(ref.state()[1])
    if not np.array_equal(written, live):
        return None
    return np.unique(ref.vocab[live])


def launch_window(fn):
    """Run ``fn`` with the kernel launch counts set to 0 just before and
    read just after; returns (fn's result, the counts)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    out = fn()
    return out, dict(ops.LAUNCHES)


def agg_counts(tree) -> dict:
    c = tree.agg_stats.counts
    return {k: c[k] for k in sorted(c) if k.startswith("agg_")}


def agg_phase(args, state, recs, device: str) -> dict:
    """agg.general, agg.fast and agg.clustered; returns the launch counts
    of agg.fast's checked call, the aggregate kernels' main path."""
    import torch
    from repro_torch import LSMTree

    vocab, cfg = state["vocab"], state["cfg"]

    # agg.general: overlapping levels and memtable rows
    tree, ref = state["tree"], state["ref"]
    domain = pinned_domain(ref)
    res, launches = launch_window(lambda: run_agg_check(
        tree, vocab, ref.state()[1], AGG_TABLE, "agg.general", domain))
    c = agg_counts(tree)
    check(c.get("agg_fallback_runs", 0) > 0, "agg.general: not the general path")
    check(launches["fused_zone_filter"] > 0,
          "agg.general: the fused filter never launched")
    emit({"phase": "agg.general", **res, **c,
          "bucket_edges": "host model" if domain is not None else
          "read back from the result (domain not pinned by the host model)",
          "launches": launches})

    # agg.fast: an append-only log (sequential keys), compacted
    rng = np.random.default_rng(args.seed + 1)
    n = args.fast_pairs
    fidx = rng.integers(0, vocab.shape[0], n)
    ftree = LSMTree(cfg, device=device)
    t0 = time.perf_counter()
    batch = 1 << 20
    for i in range(0, n, batch):
        ftree.put_batch(np.arange(i, min(n, i + batch), dtype=np.uint64),
                        vocab[fidx[i:i + batch]])
    ftree.compact()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    # distinct keys: every written value is live
    domain = np.sort(vocab[np.unique(fidx)])
    for r in recs.values():
        r.active = True      # the kernel phase replays agg.fast's operands
    res, fast_launches = launch_window(lambda: run_agg_check(
        ftree, vocab, fidx, AGG_TABLE, "agg.fast", domain))
    for r in recs.values():
        r.active = False
    c = agg_counts(ftree)
    for key in ("agg_fastpath_runs", "agg_launches", "agg_tiles_evaluated"):
        check(c.get(key, 0) > 0, f"agg.fast: {key} is 0")
    for name in AGG_KERNELS:
        check(fast_launches[name] > 0, f"agg.fast: kernel {name} never launched")
    emit({"phase": "agg.fast", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest within the smoke's time limit)" % n, "pairs": n,
          "ingest_s": ingest_s, "levels": ftree.shape_report()["levels"],
          "pack_widths": sorted({s.code_bits for s in ftree.all_runs()}),
          **res, **c, "launches": fast_launches})
    # the same batch again (per-SCT facts now cached), then under the
    # profiler: the card's busy time
    specs = make_specs(AGG_TABLE)
    before = dict(ftree.agg_stats.seconds)
    t0 = time.perf_counter()
    ftree.aggregate_many(specs)
    torch.cuda.synchronize()
    again = {"repeat_s": time.perf_counter() - t0,
             "repeat_stages_s": {k: v - before.get(k, 0.0) for k, v in
                                 ftree.agg_stats.seconds.items()}}
    emit({"phase": "agg.fast.profiled", **again,
          **device_busy(lambda: ftree.aggregate_many(specs))})

    # agg.clustered: narrow ranges skip tiles, a wide one and the buckets
    # take the closed form
    ctree, cref, cpreds = state["ctree"], state["cref"], state["cpreds"]
    n2 = args.clustered_pairs
    table = [(op, pred, None, None) for pred in cpreds
             for op in ("count", "sum", "min", "max")]
    table += [("count", ("range", b"ts_%012d" % (n2 // 8),
                         b"ts_%012d" % (n2 // 4 - 1)), None, None),
              ("group_count", None, ("bucket", 16), None)]
    cdomain = pinned_domain(cref)
    check(cdomain is not None, "agg.clustered: host model holds dead values")
    res, claunches = launch_window(lambda: run_agg_check(
        ctree, cref.vocab, cref.state()[1], table, "agg.clustered", cdomain))
    c = agg_counts(ctree)
    for key in ("agg_fastpath_runs", "agg_tiles_skipped",
                "agg_tiles_shortcircuit"):
        check(c.get(key, 0) > 0, f"agg.clustered: {key} is 0")
    for name in AGG_KERNELS:
        check(claunches[name] > 0,
              f"agg.clustered: kernel {name} never launched")
    emit({"phase": "agg.clustered", **res, **c, "launches": claunches})
    return fast_launches


# --------------------------------------------------------------------------- #
# compaction backends: the main write stream under 'jax' and 'numpy'
# --------------------------------------------------------------------------- #
# backend: (kernels that must launch in the phase's window, kernels that
# must not)
COMPACT_LAUNCHES = {
    "jax": (("remap_codes", "unpack_codes", "pack_codes"),
            ("remap_pack_codes",)),
    "numpy": (("pack_codes",), ("remap_codes", "remap_pack_codes")),
}


def check_same_tree(got, want, label: str) -> int:
    """Every SCT of every level of ``got`` equals ``want``'s: file ids,
    keys, seqnos, tombstones, packed words, code width, dictionary, zones
    and weight sums.  Returns the number of SCTs compared."""
    import torch

    ids = [[[s.file_id for s in lvl] for lvl in t.levels] for t in (got, want)]
    check(ids[0] == ids[1], f"{label}: file ids {ids[0]} vs {ids[1]}")
    n = 0
    for la, lb in zip(got.levels, want.levels):
        for a, b in zip(la, lb):
            what = f"{label}: SCT {a.file_id}"
            check((a.code_bits, a.disk_bytes) == (b.code_bits, b.disk_bytes),
                  f"{what}: width or size differs")
            for f in ("keys", "seqnos", "tombs"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"{what}: {f} differ")
            check(np.array_equal(a.opd.values, b.opd.values),
                  f"{what}: dictionary differs")
            check(torch.equal(a.packed, b.packed), f"{what}: words differ")
            for f in ("code_lo", "code_hi", "weight_sums"):
                check(torch.equal(getattr(a.blocks, f), getattr(b.blocks, f)),
                      f"{what}: {f} differ")
            n += 1
    return n


def compact_phase(state, backend: str, device: str) -> dict:
    """compact.<backend>: the main phase's write stream into a tree of the
    main configuration under compaction ``backend``; every SCT must equal
    the main ('jax_packed') tree's and filter_many the host model.  Returns
    the launch counts of the phase's window (ingest and filter)."""
    import dataclasses

    from repro_torch import LSMTree

    label = f"compact.{backend}"
    tree = LSMTree(dataclasses.replace(state["cfg"],
                                       compaction_backend=backend),
                   device=device)

    def drive():
        seconds = ingest(tree, state["stream"])
        return seconds, run_filter_check(tree, state["ref"], state["preds"],
                                         label)

    (seconds, res), launches = launch_window(drive)
    n_scts = check_same_tree(tree, state["tree"], label)
    must, must_not = COMPACT_LAUNCHES[backend]
    for name in must:
        check(launches[name] > 0, f"{label}: {name} never launched")
    for name in must_not:
        check(launches[name] == 0, f"{label}: {name} launched")
    emit({"phase": label, **ingest_report(tree, state["stream"], seconds),
          "scts_equal_to_main": n_scts, **res, "launches": launches})
    return launches


# --------------------------------------------------------------------------- #
# range scans on the main tree
# --------------------------------------------------------------------------- #
def range_phase(args, state) -> None:
    """main.range: ``range_lookup`` over 8 windows of 1/64 of the key space
    (the 4th on a snapshot pinned before overwrites and deletes in it, and
    then again after them), an empty and an inverted window; each held key
    for key and byte for byte against the host model."""
    import torch

    tree, ref, vocab = state["tree"], state["ref"], state["vocab"]
    space = 4 * args.pairs           # keys are uniform over [0, 4 * pairs)
    width = space // 64
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + width - 1) for i in range(8)]
    pinned_state, snap = ref.state(), tree.snapshot()
    keys, _ = pinned_state
    lo, hi = windows[3]
    inside = keys[(keys >= lo) & (keys <= hi)]
    rng = np.random.default_rng(args.seed + 2)
    over = rng.choice(inside, 64, replace=False)
    over_idx = rng.integers(0, vocab.shape[0], 64)
    gone = rng.choice(np.setdiff1d(inside, over), 16, replace=False)
    for k, j in zip(over.tolist(), over_idx.tolist()):
        tree.put(k, bytes(vocab[j]))
    ref.put(over, over_idx)
    for k in gone.tolist():
        tree.delete(k)
    ref.delete(gone)

    def expect(state_, lo, hi):
        k, idx = state_
        sel = (k >= np.uint64(lo)) & (k <= np.uint64(hi)) if lo <= hi else             np.zeros(k.shape[0], bool)
        return k[sel], vocab[idx[sel]]

    reads = [(w, None) for w in windows]
    reads[3] = (windows[3], snap)
    reads += [(windows[3], None), ((space, space + width), None),
              ((windows[0][1], windows[0][0]), None)]

    def drive():
        out = []
        for (lo, hi), sn in reads:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tree.range_lookup(lo, hi, snapshot=sn)
            out.append((got, time.perf_counter() - t0))
        return out

    out, launches = launch_window(drive)
    rows = []
    for ((lo, hi), sn), ((gk, gv), dt) in zip(reads, out):
        wk, wv = expect(pinned_state if sn is not None else ref.state(),
                        lo, hi)
        what = f"main.range [{lo}, {hi}]" + (" pinned" if sn else "")
        check(np.array_equal(gk, wk), f"{what}: keys differ "
              f"({gk.shape[0]} vs {wk.shape[0]})")
        check(gv.dtype == wv.dtype and np.array_equal(gv, wv),
              f"{what}: values differ")
        rows.append({"lo": lo, "hi": hi, "pinned": sn is not None,
                     "rows": int(gk.shape[0]), "seconds": dt})
    check(rows[8]["rows"] == rows[3]["rows"] - 16 and rows[9]["rows"] == 0
          and rows[10]["rows"] == 0, "main.range: window row counts")
    check(sum(launches.values()) == 0, f"main.range: launches {launches}")
    emit({"phase": "main.range", "window_keys": width,
          "median_s_per_window": statistics.median(r["seconds"]
                                                   for r in rows[:8]),
          "overwrites": int(over.shape[0]), "deletes": int(gone.shape[0]),
          "lookup_stages_s": dict(tree.lookup_stats.seconds),
          "windows": rows, "launches": launches})


# --------------------------------------------------------------------------- #
# the competitor codecs: one stream into the harness's five systems' trees
# --------------------------------------------------------------------------- #
# benchmarks/_harness.py's SYSTEMS by their configuration: LSM-OPD, RocksDB
# plain and heavy (zlib a block), BlobDB and BlobDB with compressed logs
CODECS = {"opd": {"codec": "opd"}, "plain": {"codec": "plain"},
          "heavy": {"codec": "heavy"}, "blob": {"codec": "blob"},
          "blob_zstd": {"codec": "blob", "blob_compress": True}}
# the blob burst overwrites this share of the live keys twice, each pass
# independently: the logs of the first pass hold about 60 % garbage once
# merged with the second, so GC rewrites them while the snapshot pins the
# logs it reads
BURST_SHARE = 0.6
# current gets after the burst (filter_many checks the current values of
# every key its predicates match): every 'blob_zstd' get decompresses a
# whole log of ~30 MB
CURRENT_GETS = 128
# the codec probe: PROBE_PARTS keys present, deleted and missing, in that
# order.  'blob_zstd' reads the first READ_PARTS of each part (64 keys):
# its every read decompresses a whole log, ~128 ms a key; its current gets
# after the burst are those 64 too
PROBE_PARTS = (768, 128, 128)
READ_PARTS = {"blob_zstd": (48, 8, 8)}


def probe_positions(name: str) -> np.ndarray:
    """The positions in the codec probe that codec ``name`` reads."""
    parts = READ_PARTS.get(name, PROBE_PARTS)
    starts = np.cumsum((0,) + PROBE_PARTS[:-1])
    return np.concatenate([np.arange(a, a + m) for a, m in zip(starts, parts)])


def agg_answers(got) -> list:
    return [(r.op, r.count, r.total, r.min_value, r.max_value, r.groups)
            for r in got]


def codec_run(cfg, name: str, stream, ref: Reference, preds, windows,
              probe, device: str) -> tuple:
    """codecs.<name>: the stream into a tree of ``cfg`` under the codec
    ``CODECS[name]``; filter_many (K=16) and aggregate_many (``AGG_TABLE``)
    under 'fused' and under 'numpy', range_lookup over ``windows`` and get
    over ``probe``, each held against the host model.  Returns (the JSON
    line, the answers, the tree)."""
    import dataclasses

    import torch
    from repro_torch import LSMTree, Predicate

    label = f"codecs.{name}"
    t_run = time.perf_counter()
    tree = LSMTree(dataclasses.replace(cfg, **CODECS[name]), device=device)
    vocab = ref.vocab
    specs = make_specs(AGG_TABLE)

    def timed(fn, stats):
        before = dict(stats.seconds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, {
            k: v - before.get(k, 0.0) for k, v in stats.seconds.items()}

    def drive():
        out = {"ingest_s": ingest(tree, stream)}
        for backend in ("fused", "numpy"):
            tree.cfg = dataclasses.replace(tree.cfg, filter_backend=backend)
            out[backend] = timed(
                lambda: tree.filter_many([Predicate(*p) for p in preds]),
                tree.filter_stats)
            out[f"agg.{backend}"] = timed(lambda: tree.aggregate_many(specs),
                                          tree.agg_stats)
        tree.cfg = dataclasses.replace(tree.cfg, filter_backend="fused")
        out["range"] = []
        for lo, hi in windows:
            t0 = time.perf_counter()
            got = tree.range_lookup(lo, hi)
            out["range"].append((got, time.perf_counter() - t0))
        t0 = time.perf_counter()
        out["get"] = [tree.get(k) for k in probe.tolist()]
        out["get_s"] = time.perf_counter() - t0
        return out

    out, launches = launch_window(drive)
    n_match = 0
    for backend in ("fused", "numpy"):
        n_match = check_filters(out[backend][0], ref, preds,
                                f"{label} {backend}")
        check_aggs(out[f"agg.{backend}"][0], vocab, ref.state()[1],
                   AGG_TABLE, f"{label} agg {backend}", pinned_domain(ref))
    check(agg_answers(out["agg.fused"][0]) == agg_answers(out["agg.numpy"][0]),
          f"{label}: aggregates differ between 'fused' and 'numpy'")
    live_keys, live_idx = ref.state()
    for (lo, hi), ((gk, gv), _) in zip(windows, out["range"]):
        sel = (live_keys >= np.uint64(lo)) & (live_keys <= np.uint64(hi))
        check(np.array_equal(gk, live_keys[sel]) and gv.dtype == vocab.dtype
              and np.array_equal(gv, vocab[live_idx[sel]]),
              f"{label}: range_lookup [{lo}, {hi}] differs")
    for k, got in zip(probe.tolist(), out["get"]):
        check(got == ref.get(k), f"{label}: get({k}) = {got!r}")
    if name == "opd":
        for kernel in ("pack_codes", "fused_zone_filter"):
            check(launches[kernel] > 0, f"{label}: {kernel} never launched")
    else:
        check(sum(launches.values()) == 0, f"{label}: launches {launches}")
    shape = tree.shape_report()
    n_ops = stream[0].shape[0] + stream[3].shape[0]
    line = {"phase": label, **CODECS[name], "ops": n_ops,
            "ingest_s": out["ingest_s"],
            "ops_per_s": n_ops / out["ingest_s"],
            "flush_s": tree.flush_stats.total(),
            "compaction_stages_s": dict(tree.compaction_stats.seconds),
            "n_flushes": shape["n_flushes"],
            "n_compactions": shape["n_compactions"],
            "levels": shape["levels"], "level_bytes": shape["level_bytes"],
            "disk_bytes": shape["disk_bytes"], "k": len(preds),
            "rows_matched": n_match,
            "filter_many_s": {b: out[b][1] for b in ("fused", "numpy")},
            "filter_stages_s": {b: out[b][2] for b in ("fused", "numpy")},
            "aggregate_many_s": {b: out[f"agg.{b}"][1]
                                 for b in ("fused", "numpy")},
            "agg_stages_s": {b: out[f"agg.{b}"][2]
                             for b in ("fused", "numpy")},
            "agg_counts": agg_counts(tree),
            "range_median_s": statistics.median(dt for _, dt in out["range"]),
            "range_rows": [int(gk.shape[0]) for (gk, _), _ in out["range"]],
            "gets": int(probe.shape[0]),
            "get_us": out["get_s"] / probe.shape[0] * 1e6,
            "launches": launches}
    if tree.blob_mgr is not None:
        line.update(blob_report(tree))
    line["seconds"] = time.perf_counter() - t_run
    answers = ([(r.keys, r.values) for b in ("fused", "numpy")
                for r in out[b][0]], [got for got, _ in out["range"]],
               out["get"], agg_answers(out["agg.fused"][0]))
    return line, answers, tree


def blob_report(tree) -> dict:
    mgr = tree.blob_mgr
    return {"gc_runs": mgr.gc_runs,
            "gc_bytes_rewritten": mgr.gc_bytes_rewritten,
            "blob_logs": len(mgr.live),
            "blob_log_bytes": sum(tree.store.size_of(f) for f in mgr.live)}


def blob_burst(tree, name: str, ref: Reference, preds, probe, before,
               rng) -> None:
    """codecs.<name>.burst, on a blob tree after the cross-tree comparison:
    a snapshot, then two passes that each overwrite ``BURST_SHARE`` of the
    live keys, and a full compaction, so that compaction and GC run while
    the snapshot pins its logs.  At the snapshot, filter_many and the gets
    of ``probe`` must return ``before`` (the tree's answers before the
    burst); current reads the burst's values.  Released (``del`` and
    ``gc.collect()``), the snapshot's logs go at the next GC pass."""
    import gc

    import torch
    from repro_torch import Predicate

    label = f"codecs.{name}.burst"
    t_run = time.perf_counter()
    live_keys = ref.state()[0]
    m = int(BURST_SHARE * live_keys.shape[0])
    passes = [(np.sort(rng.choice(live_keys, m, replace=False)),
               rng.integers(0, ref.vocab.shape[0], m)) for _ in range(2)]
    after = Reference(ref.vocab)
    after.ops = list(ref.ops) + passes
    tp = [Predicate(*p) for p in preds]
    mgr = tree.blob_mgr
    current = min(CURRENT_GETS, probe.shape[0])
    snap = tree.snapshot()
    runs0 = mgr.gc_runs

    def drive():
        t0 = time.perf_counter()
        for keys, idx in passes:
            tree.put_batch(keys, ref.vocab[idx])
        tree.compact()
        torch.cuda.synchronize()
        out = {"burst_s": time.perf_counter() - t0,
               "gc_runs_pinned": mgr.gc_runs - runs0,
               "pinned_candidates": len(mgr.gc_candidates())}
        t0 = time.perf_counter()
        out["snap_filter"] = tree.filter_many(tp, snapshot=snap)
        out["snap_get"] = [tree.get(k, snapshot=snap)
                           for k in probe.tolist()]
        out["snap_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["filter"] = tree.filter_many(tp)
        out["get"] = [tree.get(k) for k in probe[:current].tolist()]
        out["current_s"] = time.perf_counter() - t0
        return out

    out, launches = launch_window(drive)
    fa, _, ga, _ = before
    check(all(np.array_equal(r.keys, ka) and np.array_equal(r.values, va)
              for r, (ka, va) in zip(out["snap_filter"], fa)),
          f"{label}: filter_many at the snapshot differs from before")
    check(out["snap_get"] == ga, f"{label}: gets at the snapshot differ")
    n_match = check_filters(out["filter"], after, preds, label)
    for k, got in zip(probe[:current].tolist(), out["get"]):
        check(got == after.get(k), f"{label}: get({k}) = {got!r}")
    check(out["gc_runs_pinned"] > 0, f"{label}: GC never ran")
    check(out["pinned_candidates"] > 0,
          f"{label}: no log past the threshold was pinned")
    check(sum(launches.values()) == 0, f"{label}: launches {launches}")
    del snap
    gc.collect()
    t0 = time.perf_counter()
    runs1 = mgr.gc_runs
    tree._gc_blobs()
    released_s = time.perf_counter() - t0
    check(mgr.gc_candidates() == [],
          f"{label}: logs left past the threshold after the release")
    check(mgr.gc_runs > runs1, f"{label}: the release freed nothing")
    emit({"phase": label, "puts": 2 * m, "burst_s": out["burst_s"],
          "n_flushes": tree.n_flushes, "n_compactions": tree.n_compactions,
          "gc_runs_pinned": out["gc_runs_pinned"],
          "pinned_candidates": out["pinned_candidates"],
          "gc_runs_released": mgr.gc_runs - runs1, "gc_released_s": released_s,
          **blob_report(tree), "disk_bytes": tree.disk_bytes,
          "snapshot_reads_s": out["snap_s"],
          "current_reads_s": out["current_s"],
          "snapshot_gets": int(probe.shape[0]),
          "current_gets": current,
          "rows_matched": n_match, "launches": launches,
          "seconds": time.perf_counter() - t_run})


def codecs_phase(args, device: str) -> dict:
    """codecs: one seeded stream (the main phase's generator at
    ``--codec-pairs`` pairs) into a tree of the main configuration for
    each of the harness's five systems; the five must give the same
    answers, each equal to the host model, and the four competitors launch
    no kernel.  Then each blob tree takes its burst (``blob_burst``).
    Returns the 'opd' tree's ingest figures (sync maintenance), which the
    background phase prints beside its own."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)
    n, cfg = args.codec_pairs, main_config()
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    ref = Reference(vocab)
    ref.put(keys, vidx)
    ref.delete(dels)
    preds = make_preds(vocab)
    space = 4 * n                # keys are uniform over [0, 4 n)
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + space // 64 - 1)
               for i in range(8)]
    present, deleted, missing = PROBE_PARTS
    probe = np.concatenate([rng.choice(keys, present), dels[:deleted],
                            rng.integers(4 * n, 8 * n, missing,
                                         dtype=np.uint64)])
    check(pinned_domain(ref) is not None,
          "codecs: a written value has no live row (bucket edges unpinned)")
    emit({"phase": "codecs", "reduced": "pairs 6.4e7 -> %.1e ('heavy' "
          "compaction's zlib within the smoke's time limit)" % n, "pairs": n,
          "deletes": int(dels.shape[0]), "value_width": cfg.value_width,
          "ndv": int(vocab.shape[0]), "file_bytes": cfg.file_bytes,
          "codecs": list(CODECS), "burst_share": BURST_SHARE})
    first = None
    for name in CODECS:
        at = probe_positions(name)
        line, answers, tree = codec_run(cfg, name, stream, ref, preds,
                                        windows, probe[at], device)
        emit(line)
        if name == "opd":
            opd_ingest = {k: line[k] for k in ("ops", "ingest_s", "ops_per_s",
                                               "n_flushes", "n_compactions")}
        if first is None:
            first = answers
        else:
            # the gets are compared at the probe positions this codec read
            (fa, ra, ga, aa), (fb, rb, gb, ab) = first, answers
            check(all(np.array_equal(ka, kb) and np.array_equal(va, vb)
                      for (ka, va), (kb, vb) in zip(fa + ra, fb + rb))
                  and [ga[i] for i in at.tolist()] == gb and aa == ab,
                  f"codecs.{name}: answers differ from 'opd'")
        if tree.blob_mgr is not None:
            # both blob trees take the same burst
            blob_burst(tree, name, ref, preds, probe[at], answers,
                       np.random.default_rng(args.seed + 4))
        del tree
    emit({"phase": "codecs.done", "seconds": time.perf_counter() - t_phase})
    return opd_ingest


# --------------------------------------------------------------------------- #
# durability in sync mode: spill files, manifest, WAL, a crash and restores
# --------------------------------------------------------------------------- #
def prefix_model(stream, k: int) -> Reference:
    """The host model of the stream's first ``k`` mutations (the puts in
    order, then the deletes)."""
    keys, vocab, vidx, dels = stream
    n = keys.shape[0]
    model = Reference(vocab)
    model.put(keys[:min(k, n)], vidx[:min(k, n)])
    model.delete(dels[:max(0, k - n)])
    return model


def durable_checks(tree, model: Reference, preds, windows, probe,
                   label: str) -> tuple:
    """filter_many (K=16) under 'fused', range_lookup over ``windows``, get
    over ``probe`` and aggregate_many (``AGG_TABLE``), each held against
    ``model``; returns (the answers, the seconds)."""
    import torch
    from repro_torch import Predicate

    t0 = time.perf_counter()
    got = tree.filter_many([Predicate(*p) for p in preds])
    check_filters(got, model, preds, label)
    live_keys, live_idx = model.state()
    vocab = model.vocab
    ranges = []
    for lo, hi in windows:
        gk, gv = tree.range_lookup(lo, hi)
        sel = (live_keys >= np.uint64(lo)) & (live_keys <= np.uint64(hi))
        check(np.array_equal(gk, live_keys[sel]) and gv.dtype == vocab.dtype
              and np.array_equal(gv, vocab[live_idx[sel]]),
              f"{label}: range_lookup [{lo}, {hi}] differs")
        ranges.append((gk, gv))
    gets = [tree.get(k) for k in probe.tolist()]
    for k, g in zip(probe.tolist(), gets):
        check(g == model.get(k), f"{label}: get({k}) = {g!r}")
    aggs = tree.aggregate_many(make_specs(AGG_TABLE))
    check_aggs(aggs, vocab, live_idx, AGG_TABLE, f"{label} agg",
               pinned_domain(model))
    torch.cuda.synchronize()
    return ([(r.keys, r.values) for r in got], ranges, gets,
            agg_answers(aggs)), time.perf_counter() - t0


def same_answers(a, b) -> bool:
    (fa, ra, ga, aa), (fb, rb, gb, ab) = a, b
    return (all(np.array_equal(ka, kb) and np.array_equal(va, vb)
                for (ka, va), (kb, vb) in zip(fa + ra, fb + rb))
            and ga == gb and aa == ab)


def spill_report(spill: str, trees) -> dict:
    """The spill directory's files by kind, and the stores' spill writes."""
    import os

    kinds = collections.defaultdict(lambda: [0, 0])
    for name in os.listdir(spill):
        kind = ("sct_or_log" if name.endswith(".bin") else "wal"
                if name.endswith(".wal") else "manifest"
                if name.endswith(".log") else "other")
        kinds[kind][0] += 1
        kinds[kind][1] += os.path.getsize(os.path.join(spill, name))
    return {"files": {k: {"files": v[0], "bytes": v[1]}
                      for k, v in sorted(kinds.items())},
            "spill_writes_s": sum(t.store.spill_seconds for t in trees),
            "spill_write_bytes": sum(t.store.spill_bytes for t in trees)}


def wal_report(tree) -> dict:
    r = tree.shape_report()
    return {k: r[k] for k in ("wal_appends", "wal_syncs", "wal_bytes",
                              "wal_replayed")}


def durable_phase(args, device: str) -> None:
    """durable: the main configuration with ``wal_sync='group'`` and a
    spill directory, the main phase's generator at ``--durable-pairs``.
    ``compact.before_manifest`` is armed and the stream ingested until it
    fires; the WAL loses its unsynced tail (``simulate_power_loss``) and
    the tree is dropped.  ``LSMTree.restore`` on the card must recover a
    seqno K between the WAL's durable floor and the mutations issued, and
    the restored tree answer as the host model of the first K mutations;
    then it takes the rest of the stream and must answer as the whole
    model, its launch window (restore, reads, ingest) holding
    fused_zone_filter, unpack_codes, remap_pack_codes and pack_codes.  A
    planned ``close`` and a second restore must give every SCT back equal
    (the packed words by ``torch.equal``) and the same answers."""
    import dataclasses
    import gc
    import tempfile

    import torch
    from repro_torch import LSMTree
    from repro_torch.storage.devices import DEVICES
    from repro_torch.testing.crashpoints import CRASH, SimulatedCrash

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 5)
    n, cfg = args.durable_pairs, dataclasses.replace(main_config(),
                                                     wal_sync="group")
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    n_muts = n + dels.shape[0]
    preds = make_preds(vocab)
    space = 4 * n
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + space // 64 - 1)
               for i in range(8)]
    present, deleted, missing = PROBE_PARTS
    probe = np.concatenate([rng.choice(keys, present), dels[:deleted],
                            rng.integers(4 * n, 8 * n, missing,
                                         dtype=np.uint64)])
    emit({"phase": "durable", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest with a WAL record per write, twice restored, within the "
          "smoke's time limit; halved from 2^21 to keep the whole smoke "
          "within 720 s)" % n, "pairs": n,
          "deletes": int(dels.shape[0]), "value_width": cfg.value_width,
          "file_bytes": cfg.file_bytes, "wal_sync": cfg.wal_sync,
          "wal_group_bytes": cfg.wal_group_bytes,
          "crash_point": "compact.before_manifest"})
    line = {"phase": "durable.done"}
    with tempfile.TemporaryDirectory() as spill:
        tree = LSMTree(cfg, spill_dir=spill, device=device)
        t0 = time.perf_counter()
        with CRASH.armed("compact.before_manifest"):
            try:
                ingest(tree, stream)
            except SimulatedCrash:
                pass
            check(CRASH.fired == "compact.before_manifest",
                  "durable: compact.before_manifest never fired")
            floor, issued = tree.wal.durable_seqno, tree._seqno
            tree.wal.simulate_power_loss()
        line["crash"] = {"ingest_s": time.perf_counter() - t0,
                         "issued": issued, "durable_floor": floor,
                         "n_flushes": tree.n_flushes,
                         "levels": tree.shape_report()["levels"],
                         **wal_report(tree), **spill_report(spill, [tree])}
        crashed_fids = set(tree.store.fids())
        del tree
        gc.collect()

        def drive():
            out = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = LSMTree.restore(cfg, spill, device=device)
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
            out["orphans"] = len(crashed_fids - set(back.store.fids()))
            k = back._seqno
            check(floor <= k <= issued, f"durable: recovered seqno {k} "
                  f"outside [{floor}, {issued}]")
            out["k"] = k
            _, out["checks_s"] = durable_checks(
                back, prefix_model(stream, k), preds, windows, probe,
                "durable.restored")
            t0 = time.perf_counter()
            batch = 1 << 20
            for i in range(min(k, n), n, batch):
                j = min(n, i + batch)
                back.put_batch(keys[i:j], vocab[vidx[i:j]])
            for d in dels[max(0, k - n):].tolist():
                back.delete(d)
            torch.cuda.synchronize()
            out["resume_s"] = time.perf_counter() - t0
            out["answers"], out["final_checks_s"] = durable_checks(
                back, prefix_model(stream, n_muts), preds, windows, probe,
                "durable.resumed")
            return back, out

        (back, out), launches = launch_window(drive)
        for kernel in ("fused_zone_filter", "unpack_codes",
                       "remap_pack_codes", "pack_codes"):
            check(launches[kernel] > 0,
                  f"durable: {kernel} never launched on the restored tree")
        check(back._seqno == n_muts, f"durable: seqno {back._seqno}")
        k = out["k"]
        resumed = issued - k + (n_muts - issued)
        line.update({
            "recovered_seqno": k, "mutations": n_muts,
            "restore": {"seconds": out["restore_s"],
                        "stages_s": dict(back.restore_stats.seconds),
                        "orphans_deleted": out["orphans"],
                        "wal_replayed": back.wal_replayed},
            "checks_s": out["checks_s"],
            "resume": {"ops": resumed, "seconds": out["resume_s"],
                       "ops_per_s": resumed / out["resume_s"],
                       "n_flushes": back.n_flushes,
                       "n_compactions": back.n_compactions,
                       "flush_s": back.flush_stats.total(),
                       "compaction_stages_s": dict(
                           back.compaction_stats.seconds),
                       **wal_report(back)},
            "ingest_ops_per_s_with_wal": (issued + resumed) / (
                line["crash"]["ingest_s"] + out["resume_s"]),
            "final_checks_s": out["final_checks_s"],
            "levels": back.shape_report()["levels"],
            "io_report": {name: back.io_report(dev)
                          for name, dev in sorted(DEVICES.items())},
            "launches": launches})
        before = {s.file_id: s for s in back.all_runs()}
        back.close()
        line["closed"] = spill_report(spill, [back])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = LSMTree.restore(cfg, spill, device=device)
        torch.cuda.synchronize()
        line["reopen"] = {"seconds": time.perf_counter() - t0,
                          "stages_s": dict(again.restore_stats.seconds),
                          "wal_replayed": again.wal_replayed}
        check(again._seqno == n_muts, f"durable: reopened at {again._seqno}")
        ids = [[s.file_id for s in lvl] for lvl in again.levels]
        check(ids == [[s.file_id for s in lvl] for lvl in back.levels],
              f"durable: file ids after the reopen {ids}")
        for s in again.all_runs():
            old, what = before[s.file_id], f"durable: SCT {s.file_id}"
            check(torch.equal(s.packed, old.packed), f"{what}: words differ")
            check(s.code_bits == old.code_bits
                  and s.disk_bytes == old.disk_bytes,
                  f"{what}: width or size differs")
            for f in ("keys", "seqnos", "tombs"):
                check(np.array_equal(getattr(s, f), getattr(old, f)),
                      f"{what}: {f} differ")
            check(np.array_equal(s.opd.values, old.opd.values),
                  f"{what}: dictionary differs")
            for f in ("code_lo", "code_hi", "weight_sums"):
                check(torch.equal(getattr(s.blocks, f),
                                  getattr(old.blocks, f)),
                      f"{what}: {f} differ")
        answers, line["reopen"]["checks_s"] = durable_checks(
            again, prefix_model(stream, n_muts), preds, windows, probe,
            "durable.reopened")
        check(same_answers(answers, out["answers"]),
              "durable: answers after the reopen differ from before")
        line["reopen"]["scts_equal"] = len(before)
        again.close()
        del back, again, before
        gc.collect()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)


# --------------------------------------------------------------------------- #
# background maintenance: the workers launch the kernels off the writer's
# thread while a reader thread serves batches
# --------------------------------------------------------------------------- #
BACKGROUND_BATCH = 1 << 16   # pairs a put_batch call


def background_phase(args, recs, sync_ingest: dict, device: str) -> None:
    """background: the main configuration with ``maintenance='background'``
    and the main phase's generator at ``--background-pairs``.  The writer
    ingests with put_batch while a reader thread, once the first flush has
    installed a run, drives a ``ScanServer(maintenance='background')`` in
    batches of the 16 predicates and 2 selective aggregates, each batch on
    its own snapshot and checked against the stream written so far (keys
    sorted and unique, every value satisfying its predicate, every pair
    one the stream wrote) and against the host model of the stream's
    first ``snap.seqno`` mutations (every scan and aggregate equal).  Each
    batch records whether a flush or compaction job was in flight at its
    start and end, and each of the reader's fused_zone_filter calls
    whether one was as it launched: at least one must have been.  After
    ``drain`` the tree must answer filter_many
    (K=16), 8 range_lookup windows, 1,024 gets and the 6 aggregate specs
    as the host model, and so must one ``ScanServer(maintenance='sync')``
    batch; the scheduler must have run a flush and a compaction.  The
    launch counts are reset before the ingest and read after ``drain``, so
    the workers' launches fall inside the window: pack_codes,
    unpack_codes, remap_pack_codes and fused_zone_filter must each be
    above 0.  Every Recorder stays off: the workers call the wrappers
    from their own threads."""
    import dataclasses
    import gc
    import threading

    import torch
    from repro_torch import LSMTree, Predicate, ScanServer
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    for r in recs.values():
        r.active = False
    rng = np.random.default_rng(args.seed + 6)
    n = args.background_pairs
    cfg = dataclasses.replace(main_config(), maintenance="background")
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    preds = make_preds(vocab)
    space = 4 * n
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + space // 64 - 1)
               for i in range(8)]
    present, deleted, missing = PROBE_PARTS
    probe = np.concatenate([rng.choice(keys, present), dels[:deleted],
                            rng.integers(4 * n, 8 * n, missing,
                                         dtype=np.uint64)])
    model = prefix_model(stream, n + dels.shape[0])
    # a written pair as key * ndv + vocabulary index, with the position of
    # its first write; a vocabulary value's index by a sorted search
    ndv = vocab.shape[0]
    pairs, first = np.unique(keys.astype(np.int64) * ndv + vidx,
                             return_index=True)
    order = np.argsort(vocab)
    sorted_vocab = vocab[order]
    hits = [vocab_hits(vocab, p) for p in preds]
    emit({"phase": "background", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest beside a reader thread, within the smoke's time limit)" % n,
          "pairs": n, "deletes": int(dels.shape[0]),
          "value_width": cfg.value_width, "file_bytes": cfg.file_bytes,
          "maintenance": cfg.maintenance, "put_batch": BACKGROUND_BATCH,
          "l0_slowdown": cfg.l0_slowdown_trigger,
          "l0_stop": cfg.l0_stop_trigger,
          "max_immutables": cfg.max_immutables})

    def check_batch(out, scan_rids, upto: int, label: str) -> int:
        """Each scan of a batch against the first ``upto`` puts."""
        rows = 0
        for hit, rid in zip(hits, scan_rids):
            r = out[rid]
            k = r.keys.astype(np.int64)
            check(np.all(k[1:] > k[:-1]),
                  f"{label}: keys not sorted and unique")
            pos = np.searchsorted(sorted_vocab, r.values)
            pos = np.minimum(pos, ndv - 1)
            check(np.array_equal(sorted_vocab[pos], r.values),
                  f"{label}: a value outside the vocabulary")
            idx = order[pos]
            check(bool(hit[idx].all()),
                  f"{label}: a value fails its predicate")
            at = np.minimum(np.searchsorted(pairs, k * ndv + idx),
                            pairs.shape[0] - 1)
            check(bool(np.all(pairs[at] == k * ndv + idx))
                  and bool(np.all(first[at] < upto)),
                  f"{label}: a pair the stream had not written")
            rows += int(k.shape[0])
        return rows

    def submit_batch(srv):
        specs = make_specs(SERVE_AGGS)
        rids = srv.submit_many([Predicate(*p) for p in preds[:8]])
        agg_rids = [srv.submit_agg(specs[0])]
        rids += srv.submit_many([Predicate(*p) for p in preds[8:]])
        agg_rids.append(srv.submit_agg(specs[1]))
        return rids, agg_rids

    done = threading.Event()
    errors, walls, rows = [], [], []
    # per reader batch: its snapshot's runs and seqno, and whether a flush
    # or compaction job was in flight on the workers at its start and end
    runs_seen, seqnos, busy_start, busy_end = [], [], [], []
    line = {"phase": "background.done"}
    ops.reset_launches()
    with LSMTree(cfg, device=device) as tree:
        srv = ScanServer(tree, max_batch=len(preds) + len(SERVE_AGGS),
                         maintenance="background")
        sched = tree._sched

        def busy() -> bool:
            return bool(sched._flush_inflight or sched._compact_inflight)

        def idle() -> bool:
            return not (busy() or tree._pending_flushes()
                        or tree._compaction_debt() > 0.0)

        # the reader's fused_zone_filter calls, each noting whether a
        # worker job was in flight as it launched (the wrapper the
        # Recorder holds is called as before)
        fused = ops.fused_zone_filter
        beside = []

        def fused_noting(*a, **k):
            if threading.current_thread().name == "reader":
                beside.append(busy())
            return fused(*a, **k)

        def reader():
            # waits for the first flushed run, then serves until the writer
            # is done and the fused filter launched beside a worker job
            # (or the workers are idle, which the checks then refuse)
            try:
                while not tree.all_runs() and not (done.is_set()
                                                   and idle()):
                    time.sleep(0.005)
                while not (done.is_set() and (any(beside) or idle())):
                    rids, agg_rids = submit_batch(srv)
                    t0 = time.perf_counter()
                    busy_start.append(busy())
                    snap = tree.snapshot()
                    runs_seen.append(len(snap.runs))
                    seqnos.append(snap.seqno)
                    out = srv.step(snapshot=snap)
                    torch.cuda.synchronize()
                    busy_end.append(busy())
                    walls.append(time.perf_counter() - t0)
                    # the snapshot holds exactly the stream's first
                    # snap.seqno mutations
                    rows.append(check_batch(out, rids, min(snap.seqno, n),
                                            "background.reader"))
                    at = prefix_model(stream, snap.seqno)
                    check_filters([out[r] for r in rids], at, preds,
                                  "background.reader")
                    check_aggs([out[r] for r in agg_rids], vocab,
                               at.state()[1], SERVE_AGGS,
                               "background.reader")
            except BaseException as e:   # SystemExit from check included
                errors.append(e)

        th = threading.Thread(target=reader, name="reader")
        ops.fused_zone_filter = fused_noting
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(0, n, BACKGROUND_BATCH):
                j = min(n, i + BACKGROUND_BATCH)
                tree.put_batch(keys[i:j], vocab[vidx[i:j]])
                if i == 0:   # the reader's batches never see an empty tree
                    th.start()
            for k in dels.tolist():
                tree.delete(k)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
        finally:
            done.set()
            if th.is_alive():
                th.join(timeout=120)
            ops.fused_zone_filter = fused
        reader_s = time.perf_counter() - t0
        check(not th.is_alive(), "background: the reader never stopped")
        if errors:
            fail(f"background: the reader failed: {errors[0]!r}")
        check(any(beside),
              f"background: the reader's fused_zone_filter never launched "
              f"beside a worker job ({beside}; runs {runs_seen}, in flight "
              f"at the start {busy_start} and the end {busy_end})")
        t1 = time.perf_counter()
        tree.drain(timeout=300)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t1
        launches = dict(ops.LAUNCHES)
        for kernel in MAIN_KERNELS:
            check(launches[kernel] > 0,
                  f"background: {kernel} never launched ({launches}; reader "
                  f"batches over {runs_seen} runs)")
        check(sched.n_bg_flushes >= 1 and sched.n_bg_compactions >= 1,
              f"background: {sched.n_bg_flushes} flushes and "
              f"{sched.n_bg_compactions} compactions on the workers")
        check(tree._pending_flushes() == 0
              and tree._compaction_debt() == 0.0,
              "background: drain left work behind")
        _, checks_s = durable_checks(tree, model, preds, windows, probe,
                                     "background.drained")
        sync_srv = ScanServer(tree, max_batch=len(preds) + len(SERVE_AGGS),
                              maintenance="sync")
        rids, agg_rids = submit_batch(sync_srv)
        t2 = time.perf_counter()
        out = sync_srv.step()
        sync_batch_s = time.perf_counter() - t2
        check(not sync_srv.queue, "background: the sync batch left requests")
        check_filters([out[r] for r in rids], model, preds,
                      "background.sync_server")
        check_aggs([out[r] for r in agg_rids], vocab, model.state()[1],
                   SERVE_AGGS, "background.sync_server")
        shape = tree.shape_report()
        n_ops = n + int(dels.shape[0])
        st = srv.stats
        line.update({
            "ops": n_ops, "ingest_s": ingest_s, "ops_per_s": n_ops / ingest_s,
            "reader_until_s": reader_s, "drain_s": drain_s,
            "n_bg_flushes": sched.n_bg_flushes,
            "n_bg_compactions": sched.n_bg_compactions,
            "n_flushes": shape["n_flushes"],
            "n_compactions": shape["n_compactions"],
            "write_slowdowns": shape["write_slowdowns"],
            "slowdown_seconds": shape["slowdown_seconds"],
            "write_stalls": shape["write_stalls"],
            "stall_seconds": shape["stall_seconds"],
            "throttle_s": dict(tree.throttle_stats.seconds),
            "flush_s": tree.flush_stats.total(),
            "compaction_stages_s": dict(tree.compaction_stats.seconds),
            "levels": shape["levels"],
            "reader": {"batches": st.n_batches, "runs_seen": runs_seen,
                       "seqnos": seqnos, "busy_start": busy_start,
                       "busy_end": busy_end,
                       "fused_calls": len(beside),
                       "fused_calls_beside_a_worker": sum(beside),
                       "batch_sizes": sorted(set(st.batch_sizes)),
                       "wall_s_median": statistics.median(walls),
                       "wall_s_max": max(walls),
                       "wait_s_median": statistics.median(st.wait_seconds),
                       "rows_checked": sum(rows)},
            "checks_s": checks_s, "sync_batch_s": sync_batch_s,
            "launches": launches,
            "sync_codecs_opd_ingest": sync_ingest})
    del tree, srv, sync_srv
    gc.collect()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)


# --------------------------------------------------------------------------- #
# the paper's Figure-5 pipeline: one planned range evaluated three ways
# --------------------------------------------------------------------------- #
def fig5_pipeline(tree, vocab: np.ndarray, preds, label: str) -> dict:
    """For every SCT of ``tree`` and each predicate, the planned code range
    evaluated three ways: numpy on the host-unpacked codes,
    ``range_filter_codes`` on ``SCT.code_column`` and ``range_filter_packed``
    + ``bitmap_to_mask`` on the packed words.  The three masks must be
    equal, and equal to the host model's predicate over the SCT's
    dictionary values (located in the vocabulary), and the matches' codes
    must decode to vocabulary values the predicate holds.  Returns the
    seconds of each way and the counts."""
    import torch
    from repro_torch import Predicate
    from repro_torch.kernels import ops

    svocab = np.sort(vocab)
    hits = [vocab_hits(svocab, p) for p in preds]
    secs = {"numpy": 0.0, "range_filter_codes": 0.0,
            "range_filter_packed": 0.0}
    n_masks = n_match = 0
    runs = tree.all_runs()
    for s in runs:
        codes = s.host_codes()
        live = codes >= 0
        pos = np.searchsorted(svocab, s.opd.values)
        check(bool((pos < svocab.shape[0]).all()) and
              np.array_equal(svocab[np.minimum(pos, svocab.shape[0] - 1)],
                             s.opd.values),
              f"{label}: SCT {s.file_id} holds a value outside the vocabulary")
        col = s.code_column()
        for p, hit in zip(preds, hits):
            lo, hi = s.opd.code_range(Predicate(*p))
            # inclusive bounds; an empty plan as the engine encodes it
            k_lo, k_hi = (lo, hi - 1) if lo < hi else (1, 0)
            t0 = time.perf_counter()
            m_np = (codes >= lo) & (codes < hi)
            t1 = time.perf_counter()
            m_codes = ops.range_filter_codes(col, k_lo, k_hi)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m_packed = ops.bitmap_to_mask(
                ops.range_filter_packed(s.packed, s.code_bits, k_lo, k_hi),
                s.code_bits, s.n)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            secs["numpy"] += t1 - t0
            secs["range_filter_codes"] += t2 - t1
            secs["range_filter_packed"] += t3 - t2
            what = f"{label}: SCT {s.file_id} {p}"
            check(np.array_equal(m_codes.cpu().numpy(), m_np),
                  f"{what}: range_filter_codes differs from numpy")
            check(np.array_equal(m_packed.cpu().numpy(), m_np),
                  f"{what}: range_filter_packed differs from numpy")
            model = np.zeros(s.n, bool)
            model[live] = hit[pos[codes[live]]]
            check(np.array_equal(m_np, model),
                  f"{what}: mask differs from the host model")
            got = np.unique(codes[m_np])
            dec = s.opd.decode(got)
            where = np.searchsorted(svocab, dec)
            check(bool((where < svocab.shape[0]).all()) and
                  bool(hit[np.minimum(where, svocab.shape[0] - 1)].all()) and
                  np.array_equal(svocab[np.minimum(where,
                                                   svocab.shape[0] - 1)], dec),
                  f"{what}: a decoded match is not a value the host model "
                  "matches")
            n_masks += 1
            n_match += int(m_np.sum())
    return {"scts": len(runs), "predicates": len(preds), "masks": n_masks,
            "entries_matched": n_match, "seconds": secs}


def fig5_phase(state, recs) -> int:
    """fig5: the Figure-5 pipeline over every SCT of the main tree for its
    16 predicates; returns the launches of ``range_filter_packed`` in the
    phase's window."""
    tree = state["tree"]
    recs["packed"].active = True
    res, launches = launch_window(lambda: fig5_pipeline(
        tree, state["vocab"], state["preds"], "fig5"))
    recs["packed"].active = False
    for name in ("range_filter_packed", "range_filter_codes", "unpack_codes"):
        check(launches[name] > 0, f"fig5: {name} never launched")
    emit({"phase": "fig5", **res, "pack_widths": sorted(
        {s.code_bits for s in tree.all_runs()}), "launches": launches})
    return launches["range_filter_packed"]


FIG5_VW, FIG5_PUTS = 128, 200_000


def fig5_example(device: str) -> None:
    """fig5.example: ``examples/filter_analytics.py`` on the port at the
    example's own configuration (``LSMConfig(codec='opd', value_width=128,
    file_bytes=1 MiB)`` with the reference's default backends, 'numpy'
    filter and compaction; 200,000 puts from seed 0 over the 1,000-value
    'commodity/%03d/' + 80 x 'd' vocabulary): the Figure-5 pipeline on
    every SCT for ``prefix b"commodity/00"``, the full-tree ``filter``, K=16
    prefix predicates through ``filter`` and ``filter_many`` on one
    snapshot, and a ``ScanServer(max_batch=8)``, every answer held against
    the host model."""
    import torch
    from repro_torch import LSMConfig, LSMTree, Predicate, ScanServer

    rng = np.random.default_rng(0)
    n = FIG5_PUTS
    cfg = LSMConfig(value_width=FIG5_VW, file_bytes=2**20,
                    filter_backend="numpy", compaction_backend="numpy")
    vocab = np.asarray([b"commodity/%03d/" % i + b"d" * 80
                        for i in range(1000)], f"S{FIG5_VW}")
    keys = rng.integers(0, 10**9, n, dtype=np.uint64)
    vidx = rng.integers(0, 1000, n)
    ref = Reference(vocab)
    ref.put(keys, vidx)
    pred = ("prefix", b"commodity/00", b"")
    preds = [("prefix", b"commodity/%03d" % i, b"") for i in range(16)]

    def drive():
        out = {}
        tree = LSMTree(cfg, device=device)
        t0 = time.perf_counter()
        tree.put_batch(keys, vocab[vidx])
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        out["levels"] = tree.shape_report()["levels"]
        out["pipeline"] = fig5_pipeline(tree, vocab, [pred], "fig5.example")
        one = tree.filter(Predicate(*pred))
        out["filter_rows"] = check_filters([one], ref, [pred], "fig5.example")
        tp = [Predicate(*p) for p in preds]
        snap = tree.snapshot()
        tree.filter_many(tp, snapshot=snap)               # warm
        t0 = time.perf_counter()
        seq = [tree.filter(p, snapshot=snap) for p in tp]
        out["sequential_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bat = tree.filter_many(tp, snapshot=snap)
        out["filter_many_s"] = time.perf_counter() - t0
        for p, a, b in zip(preds, seq, bat):
            check(np.array_equal(a.keys, b.keys) and
                  a.values.tolist() == b.values.tolist(),
                  f"fig5.example: filter_many {p} differs from filter")
        out["rows_matched"] = check_filters(bat, ref, preds, "fig5.example")
        srv = ScanServer(tree, max_batch=8)
        rids = srv.submit_many(tp)
        served = srv.drain()
        check(srv.stats.batch_sizes == [8, 8],
              f"fig5.example: batches {srv.stats.batch_sizes}")
        check_filters([served[r] for r in rids], ref, preds,
                      "fig5.example.server")
        out["server_batches"] = srv.stats.batch_sizes
        return out

    res, launches = launch_window(drive)
    check(launches["range_filter_packed"] > 0,
          "fig5.example: range_filter_packed never launched")
    emit({"phase": "fig5.example", "puts": n, "value_width": FIG5_VW,
          "file_bytes": cfg.file_bytes, "backends": "filter 'numpy', "
          "compaction 'numpy' (the reference's defaults)", **res,
          "launches": launches})


# --------------------------------------------------------------------------- #
# the kernel micro-bench's entry points (benchmarks/bench_kernels.py)
# --------------------------------------------------------------------------- #
BENCH_CODES = 1 << 20
BLOOM_SEEDS32 = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
                 0x9E377969)
# falcon-mamba-7b's mixer at full width: d_inner 8192 = expand 2 x d_model
# 4096, d_state 16 (src/repro/configs/falcon_mamba_7b.py); batch 1, 2,048
# tokens
SSM_SHAPE = (1, 2048, 8192, 16)
SSM_TOL = 1e-4


def np_mix32(x: np.ndarray, seed: int) -> np.ndarray:
    """murmur3's 32-bit finalizer in numpy uint32 arithmetic (the host
    model of the bloom hash)."""
    x = x ^ np.uint32(seed)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def np_bloom_hits(words: np.ndarray, nbits: int, keys: np.ndarray,
                  n_hashes: int = 6) -> np.ndarray:
    """Host model of the bloom probe: a bit past the words is a miss."""
    hits = np.ones(keys.shape[0], bool)
    padded = np.concatenate([words, np.zeros(1, np.uint32)])
    for s in range(n_hashes):
        h = np_mix32(keys, BLOOM_SEEDS32[s]) % np.uint32(nbits)
        w = np.minimum(h >> np.uint32(5), words.shape[0])
        hits &= ((padded[w] >> (h & np.uint32(31))) & np.uint32(1)) == 1
    return hits


def np_ssm(u, dt, A, Bm, Cm):
    """Host model of the selective scan in float64, batch row 0."""
    x = np.zeros(A.shape, np.float64)
    y = np.zeros(u.shape[1:], np.float64)
    for t in range(u.shape[1]):
        d = dt[0, t].astype(np.float64)[:, None]
        x = np.exp(d * A) * x + (d * u[0, t].astype(np.float64)[:, None]) \
            * Bm[0, t].astype(np.float64)[None, :]
        y[t] = x @ Cm[0, t].astype(np.float64)
    return y, x


def bench_phase(args) -> tuple:
    """bench: the kernel micro-bench's three entry points on the port, on
    the card, at its shapes (2^20 codes packed at widths 8 and 16 with the
    range [1, 200]; a 2^14-bit bloom with 4,096 keys; the selective scan at
    falcon-mamba-7b's width), plus the largest documented bloom (2,048
    words) filled by mix32 with 2^20 keys, which must all hit.  Answers are
    held against host models (numpy masks, a numpy bloom, a float64 scan
    over 128 channels).  Returns the launches of the phase's window and the
    operands for the kernel rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitpack import pack_codes_plain

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 60000, BENCH_CODES).astype(np.int32)
    words = {w: pack_codes_plain(torch.from_numpy(codes % (1 << w)), w
                                 ).cuda() for w in (8, 16)}
    nbits = 1 << 14
    bloom = rng.integers(0, 2**32, nbits // 32, dtype=np.uint64
                         ).astype(np.uint32)
    bkeys = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    # the largest documented bloom, 10 bits per inserted key (the engine's
    # bloom_bits_per_key), probed with 2^20 keys, the inserted ones first
    big_bits = 2048 * 32
    ins = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    n_ins = big_bits // 10
    big = np.zeros(2048, np.uint32)
    for seed in BLOOM_SEEDS32:
        h = np_mix32(ins[:n_ins], seed) % np.uint32(big_bits)
        np.bitwise_or.at(big, h >> np.uint32(5),
                         np.uint32(1) << (h & np.uint32(31)))
    B, L, D, N = SSM_SHAPE
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, D))) * 0.1).astype(np.float32)
    A = -np.abs(rng.normal(size=(D, N))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)

    def u32(a):
        return torch.from_numpy(a.view(np.int32)).cuda()

    dev = {"bloom": (u32(bloom), nbits, u32(bkeys)),
           "big": (u32(big), big_bits, u32(ins)),
           "ssm": tuple(torch.from_numpy(a).cuda()
                        for a in (u, dt, A, Bm, Cm))}
    torch.cuda.synchronize()

    def drive():
        out = {w: ops.range_filter_packed(words[w], w, 1, 200)
               for w in (8, 16)}
        out["bloom"] = ops.bloom_probe(*dev["bloom"])
        out["big"] = ops.bloom_probe(*dev["big"])
        out["ssm"] = ops.ssm_scan(*dev["ssm"], chunk=32)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    out, launches = launch_window(drive)
    wall = time.perf_counter() - t0
    for name, n in (("range_filter_packed", 2), ("bloom_probe", 2),
                    ("ssm_scan", 1)):
        check(launches[name] == n, f"bench: {name} launched "
              f"{launches[name]} times, expected {n}")
    for w in (8, 16):
        c = codes % (1 << w)
        got = ops.bitmap_to_mask(out[w], w, BENCH_CODES).cpu().numpy()
        check(np.array_equal(got, (c >= 1) & (c <= 200)),
              f"bench: range_filter_packed width {w} differs from numpy")
    check(np.array_equal(out["bloom"].cpu().numpy(),
                         np_bloom_hits(bloom, nbits, bkeys)),
          "bench: bloom_probe differs from the host model")
    big_hits = out["big"].cpu().numpy()
    check(bool(big_hits[:n_ins].all()), "bench: an inserted key missed the "
          "bloom")
    check(np.array_equal(big_hits, np_bloom_hits(big, big_bits, ins)),
          "bench: bloom_probe (2,048 words) differs from the host model")
    y, state = out["ssm"]
    check(tuple(y.shape) == (B, L, D) and tuple(state.shape) == (B, D, N)
          and bool(torch.isfinite(y).all()) and
          bool(torch.isfinite(state).all()), "bench: ssm_scan output")
    ch = slice(0, 128)
    wy, ws = np_ssm(u[:, :, ch], dt[:, :, ch], A[ch], Bm, Cm)
    gy, gs = y[0, :, ch].cpu().double().numpy(), \
        state[0, ch].cpu().double().numpy()
    ssm_err = max(float(np.abs(gy - wy).max()), float(np.abs(gs - ws).max()))
    check(bool((np.abs(gy - wy) <= SSM_TOL + SSM_TOL * np.abs(wy)).all()) and
          bool((np.abs(gs - ws) <= SSM_TOL + SSM_TOL * np.abs(ws)).all()),
          f"bench: ssm_scan outside rtol = atol = {SSM_TOL} of the float64 "
          f"host model (max |err| {ssm_err})")
    emit({"phase": "bench", "codes": BENCH_CODES, "bloom_bits": nbits,
          "bloom_keys": int(bkeys.shape[0]),
          "bloom_hit_share": float(out["bloom"].float().mean()),
          "big_bloom_bits": big_bits, "big_bloom_keys": int(ins.shape[0]),
          "big_bloom_inserted": n_ins,
          "big_bloom_hit_share": float(big_hits.mean()),
          "ssm_shape_BLDN": list(SSM_SHAPE),
          "ssm_max_abs_err_vs_float64_model": ssm_err,
          "wall_s": wall, "launches": launches})
    return launches, {"words": words, **dev}


# --------------------------------------------------------------------------- #
# kernels against their plain versions, on operands the main path produced
# --------------------------------------------------------------------------- #
class Recorder:
    """Wraps an ops entry point; keeps the operands of its largest call
    (per key) so the kernel phase can replay the main path's shapes, and
    counts the calls of size > 0 per key in ``launches`` (on the card a
    wrapper launches its kernel once for each such call)."""

    def __init__(self, fn, size, key=lambda *a, **k: 0, active=True):
        self.fn, self.size, self.key, self.calls = fn, size, key, {}
        self.active, self.launches = active, {}

    def __call__(self, *args, **kw):
        if not self.active:
            return self.fn(*args, **kw)
        key, size = self.key(*args, **kw), self.size(*args, **kw)
        old = self.calls.get(key)
        if old is None or size > self.size(*old[0], **old[1]):
            self.calls[key] = (args, kw)
        if size > 0:
            self.launches[key] = self.launches.get(key, 0) + 1
        return self.fn(*args, **kw)


def event_median_ms(fn, inner: int, reps: int = 21, warmup: int = 2) -> float:
    """Median over ``reps`` CUDA-event-timed runs of ``inner`` back-to-back
    calls, per call, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_busy(fn) -> dict:
    """Wall seconds of one call and the seconds the card spent in kernels
    during it (torch.profiler's CUDA activity, summed per kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0) or 0
               for e in prof.key_averages()) / 1e6
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall}


def profiled_device_ms(fn, symbol: str, reps: int = 20, tries: int = 3):
    """Mean device time of the kernel ``symbol`` over ``reps`` calls, from
    torch.profiler's CUDA activity; a trace without the kernel (the
    profiler drops a window's device records now and then) is taken again,
    up to ``tries`` times, then None."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(r"(^|[^A-Za-z_])" + symbol + r"\b")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", None)
            if dt is not None and pat.search(e.key):
                total += dt
                count += e.count
        if count:
            return total / count / 1e3
    return None


def graph_ms(fns, reps: int = 21) -> float:
    """Device time per call of the calls ``fns`` without their host launch
    cost: captured in one CUDA graph, the graph replayed (median of
    ``reps`` CUDA-event-timed replays), per call.  A kernel and the one
    PyTorch call set beside it (a copy) are timed the same way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    ms = event_median_ms(graph.replay, inner=1, reps=reps) / len(fns)
    del graph
    return ms


# bytes of other calls' traffic between two calls on one copy of the
# operands in cold_graph_ms: 2.5x the 50 MB L2 of an H100
COLD_BYTES = 128 << 20


def hot_graph_ms(fn, *operands) -> float:
    """``graph_ms`` of 20 calls of ``fn`` on the same operands, which stay
    in L2 from one call to the next when they fit there."""
    return graph_ms([lambda: fn(*operands)] * 20)


def cold_graph_ms(fn, nbytes: int, *operands) -> float:
    """``graph_ms`` of one call of ``fn`` on each of enough copies of the
    operands that ``COLD_BYTES`` of the other calls' traffic (``nbytes``
    per call) pass between two calls on one copy: every call reads its
    operands from device memory, as a kernel does whose inputs were written
    long before (a flushed SCT's words, a merge's streams)."""
    copies = 1 + -(-COLD_BYTES // nbytes)
    return graph_ms([functools.partial(fn, *(t.clone() for t in operands))
                     for _ in range(copies)])


def ptxas_resources(log: str, symbol: str) -> list:
    """Registers, static shared memory, stack and spills of every compiled
    instantiation of the kernel ``symbol``, from the ``-Xptxas=-v`` output
    that the build keeps; names demangled where ``c++filt`` is found."""
    import shutil

    funcs, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                      r"(?:, (\d+) bytes smem)?", ln)
        if m and cur is not None:
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(m.group(2) or 0))
    names = [f for f in funcs if re.search(r"(?<![A-Za-z_])" + symbol, f)]
    shown = names
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            shown = out.stdout.splitlines()
    return [{"function": d, **funcs[f]} for f, d in zip(names, shown)]


def sass_functions(lib: Path) -> dict:
    """Mangled name -> [(address, opcode, operands)] of every kernel in the
    library's SASS (``cuobjdump -sass``, beside nvcc)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        funcs[chunk.split("\n", 1)[0].strip()] = [
            (int(m.group(1), 16), m.group(3), m.group(4))
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                                 r"([A-Z][A-Z0-9_.]*)([^;]*);", chunk)]
    return funcs


def sass_per_element(funcs: dict, name: str, marker: str,
                     per_marker: int) -> dict:
    """Static SASS instructions per element of the kernel whose mangled
    name contains ``name``: the smallest loop that holds an instruction
    matching ``marker`` (a regex on the opcode, an instruction issued once
    for every ``per_marker`` elements, such as a 16-byte load of 4 keys),
    over the elements of one of its iterations."""
    fn = next((k for k in funcs if name in k), None)
    if fn is None:
        return {"error": f"no kernel {name} in the SASS"}
    ins = funcs[fn]
    loops = []
    for addr, op, args in ins:
        t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) <= addr:
            loops.append([o for a, o, _ in ins
                          if int(t.group(1), 16) <= a <= addr])
    held = [lp for lp in loops if any(re.search(marker, o) for o in lp)]
    if not held:
        return {"error": f"no loop of {fn} holds {marker}"}
    body = min(held, key=len)
    elements = per_marker * sum(bool(re.search(marker, o)) for o in body)
    return {"function": fn, "loop_instructions": len(body),
            "elements_per_iteration": elements,
            "per_element": len(body) / elements,
            "loop_by_opcode": dict(collections.Counter(
                o.split(".")[0] for o in body).most_common())}


def compare(name: str, kernel, plain, nbytes: int, bw: float, launches: int,
            shape: str, tol=None, op_bound_ms: float = 0.0,
            plain_reps: int = 21) -> dict:
    """Run ``kernel`` and ``plain`` on the same operands and time both.
    Without ``tol`` the outputs must agree bit for bit; with ``tol`` every
    element must satisfy |kernel - plain| <= tol + tol * |plain|, and the
    relative error reported is max |kernel - plain| / max |plain|.  The
    bound is the larger of ``nbytes`` over the bandwidth and
    ``op_bound_ms`` (the operations over the card's rates)."""
    import torch
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    check(ops.LAUNCHES[name] > before[name], f"{name}: kernel did not launch")
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, rel = 0, 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: shape/dtype {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if not g.numel():
            continue
        if tol is None:
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
            continue
        d = (g.double() - w.double()).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float(d.max() / w.double().abs().max().clamp(min=tol)))
        check(bool((d <= tol + tol * w.double().abs()).all()),
              f"{name} ({shape}): kernel outside rtol = atol = {tol} of "
              f"plain, max |err| {err}")
    check(tol is not None or err == 0,
          f"{name} ({shape}): kernel differs from plain, max |err| {err}")
    ms = event_median_ms(kernel, inner=10)
    plain_ms = event_median_ms(plain, inner=1, reps=plain_reps, warmup=1)
    bytes_ms = nbytes / bw * 1e3
    src, rep = KERNELS[name]
    row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
           "launches": launches, "max_abs_err": err, "ms": ms,
           "device_ms": profiled_device_ms(kernel, SYMBOLS[name]),
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, op_bound_ms),
           "bytes": nbytes, "bytes_ms": bytes_ms,
           "ops_ms": op_bound_ms,
           "bound_by": "operations" if op_bound_ms > bytes_ms else "bytes",
           "library_ms": None,
           "library_why": LIBRARY_WHY.get(name, NO_LIBRARY),
           "shape": shape}
    if tol is not None:
        row.update({"tolerance": tol, "max_rel_err": rel})
    return row


def pack_row(codes, width: int, bw: float, launches: int, log: str,
             where: str) -> dict:
    """pack_codes against its plain version at one shape, with the CUDA
    graph times (hot: the same codes every call; cold: a fresh copy every
    call) and the registers of its instantiations at that width."""
    from repro_torch.kernels import bitpack

    n = codes.shape[0]
    nbytes = 4 * n + 4 * bitpack.n_words_for(n, width)
    pack = lambda c: bitpack.pack_codes(c, width)  # noqa: E731
    row = compare("pack_codes", lambda: pack(codes),
                  lambda: bitpack.pack_codes_plain(codes, width), nbytes, bw,
                  launches, f"n={n} width={width}{where}")
    row.update({
        "main_path": not where,
        "ptxas": [r for r in ptxas_resources(log, SYMBOLS["pack_codes"])
                  if f"<{width}," in r["function"]],
        "graph_ms": hot_graph_ms(pack, codes),
        "cold_graph_ms": cold_graph_ms(pack, nbytes, codes)})
    return row


def agg_gathers(words, meta, ranges, width: int, k: int, tile_words: int,
                flags) -> int:
    """Weight gathers of fused_zone_agg with SUM: the valid entries of the
    evaluated tiles (flag 1) that fall in any of their tile's K ranges."""
    import torch
    from repro_torch.kernels import agg_scan, bitpack

    ev = torch.nonzero(flags == agg_scan.FLAG_EVALUATED).reshape(-1)
    m = bitpack.from_u32_bits(meta)[ev]
    r = bitpack.from_u32_bits(ranges)
    per = 32 // width
    w = bitpack.from_u32_bits(words).reshape(-1, tile_words)[ev]
    shifts = torch.arange(per, dtype=torch.int64, device=words.device) * width
    f = ((w[:, :, None] >> shifts) & ((1 << width) - 1)).reshape(w.shape[0], -1)
    hit = torch.arange(f.shape[1], device=f.device) < m[:, 3:4]
    any_range = torch.zeros_like(hit)
    for j in range(k):
        lo, hi = r[m[:, 2] + j, 0:1], r[m[:, 2] + j, 1:2]
        any_range |= (f >= lo) & (f <= hi)
    return int((hit & any_range).sum())


def hist_sass(sass: dict, width: int, bins: int) -> dict:
    """SASS instructions per code of zone_histogram's 16-byte-load
    instantiation at ``(width, bins)``: its loop over a tile's whole
    rounds without the padding guard (the smallest that counts), one
    shared atomic a code."""
    return sass_per_element(
        sass, f"zone_histogram_kernelILi{width}ELi{bins}ELb1E", r"^ATOMS", 1)


def bloom_sass(sass: dict) -> dict:
    """SASS instructions per key of bloom_probe at a power-of-two nbits,
    16-byte key loads and the bloom in shared memory: its loop over a
    thread's steps, 4 keys a 16-byte load."""
    return sass_per_element(sass, "bloom_probe_kernelILb1ELb1ELb1E",
                            r"^LDG.*\.128", 4)


def single_filter_extras(kernel, launch, x, tile: int, fill: int,
                         nbytes: int, ptxas: list, yardstick, ops_call,
                         padded_call) -> dict:
    """What a single-range filter row adds (``range_filter_codes``,
    ``range_filter_packed``; ``kernel`` is the wrapper on its operands but
    the column, ``launch`` its module's ``_launch`` the same way, which
    takes the cluster size): the grid (tiles x cluster) and CUDA-graph
    times hot and cold at every cluster size the build instantiates, the
    wrapper's cluster size, the registers and spills of its
    instantiations, a yardstick of the same traffic cold (a copy the
    port never calls), the kernel cold on the input padded with ``fill``
    to whole tiles, and the ``ops`` entry point cold on the input as it is
    and with the pad copy that it made before (both answers equal)."""
    import torch
    from repro_torch.kernels import ops, packed_filter

    n_tiles = -(-x.shape[0] // tile)
    clusters = {}
    for c in packed_filter.CLUSTER_SIZES:
        fn = functools.partial(launch, cluster=c)
        clusters[c] = {"grid": n_tiles * c,
                       "graph_ms": hot_graph_ms(fn, x),
                       "cold_graph_ms": cold_graph_ms(fn, nbytes, x)}
    check(torch.equal(ops_call(x), padded_call(x)),
          "the ops entry point differs with the pad copy")
    whole = ops._pad_to_tiles(x, tile, fill)
    name, yard = yardstick
    mine = clusters[packed_filter.CLUSTER]
    return {"cluster": packed_filter.CLUSTER, "grid": mine["grid"],
            "graph_ms": mine["graph_ms"],
            "cold_graph_ms": mine["cold_graph_ms"], "clusters": clusters,
            "ptxas": ptxas, "yardstick": name,
            "yardstick_cold_graph_ms": cold_graph_ms(yard, nbytes, x),
            "whole_tiles": whole.shape[0],
            "whole_tiles_cold_graph_ms": cold_graph_ms(kernel, nbytes, whole),
            "ops_cold_graph_ms": cold_graph_ms(ops_call, nbytes, x),
            "ops_pad_cold_graph_ms": cold_graph_ms(padded_call, nbytes, x)}


def kernel_phase(recs, launches: dict, bw: float, bench: dict,
                 rates: dict, log: str, sass: dict) -> list:
    import torch
    from repro_torch.kernels import (agg_scan, bitpack, bloom_probe,
                                     fused_scan, merge_remap, multi_filter,
                                     opd_filter, ops, packed_filter,
                                     ssm_scan)

    rows = []
    # one row per pack width the main path packed (its flushes), then
    # compact.jax's largest pack (a merge output) beside codes.clone(), and
    # the same codes at width 16
    for width, ((codes, _w), _) in sorted(recs["pack"].calls.items()):
        rows.append(pack_row(codes, width, bw, recs["pack"].launches[width],
                             log, ""))
    (codes, width), _ = max(recs["pack_compact"].calls.values(),
                            key=lambda c: c[0][0].shape[0])
    n = codes.shape[0]
    where = " (compact.jax's largest pack: a merge output)"
    rows.append(pack_row(codes, width, bw,
                         recs["pack_compact"].launches[width], log, where))
    if width == 32:
        clone = lambda c: c.clone()  # noqa: E731
        check(torch.equal(clone(codes), bitpack.pack_codes(codes, 32)),
              "pack_codes at width 32 differs from codes.clone()")
        rows[-1].update({
            "library_ms": event_median_ms(lambda: clone(codes), inner=10),
            "library_graph_ms": hot_graph_ms(clone, codes),
            "library_cold_graph_ms": cold_graph_ms(clone, 8 * n, codes),
            "library_why": "codes.clone(): the same function only at width "
                           "32, where the pack is a copy"})
    rows.append(pack_row(codes & 0xFFFF, 16, bw, 0, log,
                         f"{where}, low 16 bits"))

    # one row per pack width the main path unpacked, at its largest call;
    # then width 16 at the width-32 row's n (the main path's width-16 SCTs
    # are flushes, a tenth of that size): the same codes repacked
    cases = [(width, words, n, recs["unpack"].launches[width], "")
             for width, ((words, _w, n), _) in sorted(
                 recs["unpack"].calls.items())]
    if 32 in recs["unpack"].calls:
        (w32, _w, n32), _ = recs["unpack"].calls[32]
        cases.append((16, bitpack.pack_codes_plain(w32[:n32] & 0xFFFF, 16),
                      n32, 0, " (the width-32 row's codes, low 16 bits, "
                      "repacked at width 16)"))
    for width, words, n, count, note in cases:
        nbytes = 4 * bitpack.n_words_for(n, width) + 4 * n
        unpack = lambda w: bitpack.unpack_codes(w, width, n)  # noqa: E731
        rows.append(compare(
            "unpack_codes", lambda: unpack(words),
            lambda: bitpack.unpack_codes_plain(words, width, n), nbytes, bw,
            count, f"n={n} width={width}{note}"))
        res = ptxas_resources(log, SYMBOLS["unpack_codes"])
        rows[-1].update({
            "ptxas": [r for r in res if f"<{width}," in r["function"]] or res,
            "main_path": not note,
            # in CUDA graphs, no host launch cost: the same words every call
            # (in L2), and a fresh copy of them every call (device memory)
            "graph_ms": hot_graph_ms(unpack, words),
            "cold_graph_ms": cold_graph_ms(unpack, nbytes, words)})
        if width == 32:
            # at width 32 the unpack is a copy; the port never calls it
            clone = lambda w: w[:n].clone()  # noqa: E731
            check(torch.equal(clone(words), unpack(words)),
                  "unpack_codes at width 32 differs from words[:n].clone()")
            # the same words 8 times over: a launch's fixed cost against
            # the rate the kernel streams at
            big = words[:n].repeat(8)
            rows[-1].update({
                "library_ms": event_median_ms(lambda: clone(words), inner=10),
                "library_graph_ms": hot_graph_ms(clone, words),
                "library_cold_graph_ms": cold_graph_ms(clone, nbytes, words),
                "library_why": "words[:n].clone(): the same function only "
                               "at width 32, where the unpack is a copy",
                "cold_graph_ms_8n": cold_graph_ms(
                    lambda w: bitpack.unpack_codes(w, width, 8 * n),
                    8 * nbytes, big),
                "library_cold_graph_ms_8n": cold_graph_ms(
                    torch.clone, 8 * nbytes, big),
                "bound_ms_8n": 8 * nbytes / bw * 1e3})

    calls = recs["fused"].calls
    biggest = max(calls.values(), key=lambda c: c[0][0].shape[0])
    for width in (8, 16, 32):
        (fw, meta, rng, w0, k, tw), _ = calls.get(width, biggest)
        if w0 != width and width < 32:  # replay another width's words
            rng = rng & ((1 << width) - 1)
        out = fused_scan.fused_zone_filter(fw, meta, rng, width, k, tw)
        torch.cuda.synchronize()
        evaluated = int(out[1].sum())
        n_tiles = meta.shape[0]
        nbytes = (4 * tw * evaluated + 4 * k * fw.shape[0] + 20 * n_tiles
                  + 8 * rng.shape[0])
        rows.append(compare(
            "fused_zone_filter",
            lambda: fused_scan.fused_zone_filter(fw, meta, rng, width, k, tw),
            lambda: fused_scan.fused_zone_filter_plain(fw, meta, rng, width,
                                                       k, tw),
            nbytes, bw, launches["fused_zone_filter"],
            f"words={fw.shape[0]} tiles={n_tiles} evaluated={evaluated} "
            f"K={k} width={width}" + ("" if w0 == width else
                                      f" (words of a width-{w0} level)")))
        filt = functools.partial(fused_scan.fused_zone_filter, width=width,
                                 n_preds=k, tile_words=tw)
        rows[-1].update({"main_path": w0 == width and fw is biggest[0][0],
                         "graph_ms": hot_graph_ms(filt, fw, meta, rng),
                         "cold_graph_ms": cold_graph_ms(filt, nbytes, fw,
                                                        meta, rng)})

    # remap_pack_codes at the main path's largest merge: device time, CUDA
    # graphs hot and cold, and cold with every entry dead (the streams
    # without a gather)
    (evs, srcs, table, offsets, width), _ = max(
        recs["remap"].calls.values(), key=lambda c: c[0][0].shape[0])
    n = evs.shape[0]
    m = bitpack.n_words_for(n, width)
    nbytes = 8 * n + 4 * m + 4 * table.shape[0] + 4 * offsets.shape[0]
    remap_pack = lambda *a: merge_remap.remap_pack_codes(*a, width)  # noqa: E731
    rows.append(compare(
        "remap_pack_codes", lambda: remap_pack(evs, srcs, table, offsets),
        lambda: merge_remap.remap_pack_codes_plain(evs, srcs, table, offsets,
                                                   width),
        nbytes, bw, recs["remap"].launches[width],
        f"n={n} width={width} table={table.shape[0]} "
        f"sources={offsets.shape[0]}"))
    rows[-1].update({
        "ptxas": [r for r in ptxas_resources(log, SYMBOLS["remap_pack_codes"])
                  if f"<{width}," in r["function"]],
        "gathers": int((evs >= 0).sum()),
        "graph_ms": hot_graph_ms(remap_pack, evs, srcs, table, offsets),
        "cold_graph_ms": cold_graph_ms(remap_pack, nbytes, evs, srcs, table,
                                       offsets),
        "streams_only_cold_graph_ms": cold_graph_ms(
            remap_pack, nbytes, torch.full_like(evs, -1), srcs, table,
            offsets)})

    # fused_zone_agg at agg.fast's scalar launch, with and without SUM; in
    # CUDA graphs hot (the same operands, in L2) and cold (a fresh copy per
    # call); with SUM each valid entry of an evaluated tile that matches one
    # of its ranges gathers one weight, a 32-byte L2 sector
    (aw, am, ar, awt, width, k, _ws, tw), _ = recs["agg"].calls[0]
    n_tiles = am.shape[0]
    for with_sum in (True, False):
        flags = agg_scan.fused_zone_agg(aw, am, ar, awt, width, k, with_sum,
                                        tw)[4]
        evaluated = int((flags == 1).sum())
        nbytes = (4 * tw * evaluated + 24 * n_tiles + 8 * ar.shape[0]
                  + 20 * n_tiles * k + 4 * n_tiles
                  + (4 * awt.shape[0] if with_sum else 0))
        agg = functools.partial(agg_scan.fused_zone_agg, width=width,
                                n_preds=k, with_sum=with_sum, tile_words=tw)
        rows.append(compare(
            "fused_zone_agg", lambda: agg(aw, am, ar, awt),
            lambda: agg_scan.fused_zone_agg_plain(aw, am, ar, awt, width, k,
                                                  with_sum, tw),
            nbytes, bw, launches["fused_zone_agg"],
            f"words={aw.shape[0]} tiles={n_tiles} evaluated={evaluated} "
            f"K={k} width={width} sum={with_sum} weights={awt.shape[0]}"))
        slots, vec = agg_scan.agg_route(aw, k, tw)
        rows[-1].update({
            "main_path": with_sum, "slots": slots, "vector_loads": vec,
            "ptxas": [r for r in ptxas_resources(log, SYMBOLS["fused_zone_agg"])
                      if f"<{width}," in r["function"]],
            "graph_ms": hot_graph_ms(agg, aw, am, ar, awt),
            "cold_graph_ms": cold_graph_ms(agg, nbytes, aw, am, ar, awt)})
        # K = 1 and 2 on the same tiles (each tile's first ranges), cold, in
        # the instantiation agg_route picks and in the 8-slot one: what the
        # 1- and 2-slot instantiations are judged by
        if vec:
            rows[-1]["slots_cold_graph_ms"] = {
                f"K={kk} slots={sl}": cold_graph_ms(functools.partial(
                    agg_scan._launch_agg, width=width, n_preds=kk,
                    with_sum=with_sum, tile_words=tw, slots=sl, vec=True),
                    nbytes, aw, am, ar, awt)
                for kk in (1, 2) for sl in (kk, 8)}
        if with_sum:
            gathers = agg_gathers(aw, am, ar, width, k, tw, flags)
            rows[-1].update({"gathers": gathers,
                             "gather_sector_bytes": 32 * gathers})

    # zone_histogram at agg.fast's largest GROUP BY launch; in CUDA graphs
    # hot and cold, with the registers and the SASS instructions per code
    # of its instantiations at that width
    (hw, hm, he, width, n_bins, tw), _ = recs["hist"].calls[0]
    n_tiles = hm.shape[0]
    evaluated = int((agg_scan.zone_histogram(hw, hm, he, width, n_bins,
                                             tw)[1] == 1).sum())
    nbytes = (4 * tw * evaluated + 24 * n_tiles + 4 * he.numel()
              + 4 * n_tiles * n_bins + 4 * n_tiles)
    rows.append(compare(
        "zone_histogram",
        lambda: agg_scan.zone_histogram(hw, hm, he, width, n_bins, tw),
        lambda: agg_scan.zone_histogram_plain(hw, hm, he, width, n_bins, tw),
        nbytes, bw, launches["zone_histogram"],
        f"words={hw.shape[0]} tiles={n_tiles} evaluated={evaluated} "
        f"bins={n_bins} width={width}"))
    hist = functools.partial(agg_scan.zone_histogram, width=width,
                             n_bins=n_bins, tile_words=tw)
    bins, vec = agg_scan.hist_route(hw, n_bins, tw)
    rows[-1].update({
        "bins": bins, "vector_loads": vec,
        "ptxas": [r for r in ptxas_resources(log, SYMBOLS["zone_histogram"])
                  if re.search(f"<{width}[,>]", r["function"])],
        "sass": {f"bins={b}": hist_sass(sass, width, b)
                 for b in agg_scan.HIST_BINS},
        "graph_ms": hot_graph_ms(hist, hw, hm, he),
        "cold_graph_ms": cold_graph_ms(hist, nbytes, hw, hm, he)})
    # both buckets of the 16-byte loads on the same tiles, cold, at
    # agg.fast's edges and at 64 bins (each of its bins cut in 4), each
    # equal to the plain version
    e16 = bitpack.from_u32_bits(he)
    steps = torch.arange(4, device=he.device)
    e64 = torch.cat([(e16[:, :-1, None] + (e16[:, 1:, None] - e16[:, :-1, None])
                      * steps // 4).reshape(e16.shape[0], -1),
                     e16[:, -1:]], dim=1)
    rows[-1]["buckets_cold_graph_ms"] = {}
    for nb, edges in ((n_bins, he), (64, bitpack.to_u32_bits(e64))):
        want = agg_scan.zone_histogram_plain(hw, hm, edges, width, nb, tw)
        for b in agg_scan.HIST_BINS:
            if nb > b:
                continue
            launch = functools.partial(
                agg_scan._launch_hist, width=width, n_bins=nb, tile_words=tw,
                bins=b, vec=True)
            got = launch(hw, hm, edges)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"zone_histogram ({b} bins) differs from plain at {nb} "
                  f"bins")
            rows[-1]["buckets_cold_graph_ms"][f"n_bins={nb} bins={b}"] = \
                cold_graph_ms(launch, nbytes, hw, hm, edges)

    # the staged backends at serve's shapes: the largest SCT of the tree
    (mw, mr, width, tw), _ = recs["multi"].calls[0]
    k, n_tiles = mr.shape[0], mw.shape[0] // tw
    rows.append(compare(
        "multi_range_filter_packed",
        lambda: multi_filter.multi_range_filter(mw, mr, width, tw),
        lambda: multi_filter.multi_range_filter_plain(mw, mr, width, tw),
        4 * mw.shape[0] + 4 * k * mw.shape[0] + 4 * k * n_tiles + 8 * k, bw,
        launches["multi_range_filter_packed"],
        f"words={mw.shape[0]} tiles={n_tiles} K={k} width={width}"))
    multi = functools.partial(multi_filter.multi_range_filter, width=width,
                              tile_words=tw)
    rows[-1].update({
        "graph_ms": hot_graph_ms(multi, mw, mr),
        "cold_graph_ms": cold_graph_ms(multi, rows[-1]["bytes"], mw, mr)})
    # range_filter_codes at serve.jax's largest call: the column as it is
    (cc, lo, hi, tc), _ = recs["codes"].calls[0]
    n_tiles = -(-cc.shape[0] // tc)
    nbytes = 5 * cc.shape[0] + 4 * n_tiles
    rows.append(compare(
        "range_filter_codes",
        lambda: opd_filter.code_range_filter(cc, lo, hi, tc),
        lambda: opd_filter.code_range_filter_plain(cc, lo, hi, tc),
        nbytes, bw, launches["range_filter_codes"],
        f"codes={cc.shape[0]} tiles={n_tiles} lo={lo} hi={hi}"))
    rows[-1].update(single_filter_extras(
        functools.partial(opd_filter.code_range_filter, lo=lo, hi=hi,
                          tile_codes=tc),
        functools.partial(opd_filter._launch, lo=lo, hi=hi, tile_codes=tc),
        cc, tc, -1, nbytes,
        ptxas_resources(log, SYMBOLS["range_filter_codes"]),
        ("codes.to(torch.int8)", lambda c: c.to(torch.int8)),
        lambda c: ops.range_filter_codes(c, lo, hi, tc),
        lambda c: opd_filter.code_range_filter(
            ops._pad_to_tiles(c, tc, -1), lo, hi, tc)[0][:c.shape[0]]
        .view(torch.bool)))

    # the plain remap at compact.jax's largest merge output; each live entry
    # gathers one table slot, a 32-byte L2 sector.  In CUDA graphs: the same
    # operands every call (in L2), a fresh copy every call (device memory),
    # and a fresh copy with every entry dead: the same ev/src streams and
    # stores with no gather, which splits the streams from the gathers
    (evs, srcs, table, offsets), _ = recs["remap_codes"].calls[0]
    n = evs.shape[0]
    dead = int((evs < 0).sum())
    nbytes = 12 * n + 4 * table.shape[0] + 4 * offsets.shape[0]
    rows.append(compare(
        "remap_codes",
        lambda: merge_remap.remap_codes(evs, srcs, table, offsets),
        lambda: merge_remap.remap_codes_plain(evs, srcs, table, offsets),
        nbytes, bw, launches["remap_codes"],
        f"n={n} dead={dead} table={table.shape[0]} "
        f"sources={offsets.shape[0]}"))
    gathers = n - dead
    remap = merge_remap.remap_codes
    rows[-1].update({
        "ptxas": ptxas_resources(log, SYMBOLS["remap_codes"]),
        "gathers": gathers, "gather_sector_bytes": 32 * gathers,
        "graph_ms": hot_graph_ms(remap, evs, srcs, table, offsets),
        "cold_graph_ms": cold_graph_ms(remap, nbytes, evs, srcs, table,
                                       offsets),
        "streams_only_cold_graph_ms": cold_graph_ms(
            remap, nbytes, torch.full_like(evs, -1), srcs, table, offsets)})

    # the Figure-5 kernel at fig5's largest SCT of the main tree, then at
    # the micro-bench's 2^20 codes
    (pw, lo, hi, width, tw), _ = recs["packed"].calls[0]
    cases = [(pw, lo, hi, width, tw, "fig5: the main tree's largest SCT")]
    cases += [(w, 1, 200, wd, packed_filter.DEFAULT_TILE_WORDS, "micro-bench")
              for wd, w in bench["words"].items()]
    for i, (pw, lo, hi, width, tw, where) in enumerate(cases):
        n_tiles = -(-pw.shape[0] // tw)
        nbytes = 8 * pw.shape[0] + 4 * n_tiles
        # per field: shift, mask, subtract, compare, shift-or; per word: a
        # popcount and the count's add
        n_ops = pw.shape[0] * (5 * (32 // width) + 2)
        rows.append(compare(
            "range_filter_packed",
            lambda: packed_filter.packed_range_filter(pw, lo, hi, width, tw),
            lambda: packed_filter.packed_range_filter_plain(pw, lo, hi, width,
                                                            tw),
            nbytes, bw, launches["range_filter_packed"],
            f"words={pw.shape[0]} tiles={n_tiles} width={width} lo={lo} "
            f"hi={hi} ({where})",
            op_bound_ms=n_ops / rates["int32_ops"] * 1e3))
        rows[-1].update({"main_path": i == 0, "int_ops": n_ops})
        rows[-1].update(single_filter_extras(
            functools.partial(packed_filter.packed_range_filter, lo=lo, hi=hi,
                              width=width, tile_words=tw),
            functools.partial(packed_filter._launch, lo=lo, hi=hi,
                              width=width, tile_words=tw),
            pw, tw, -1, nbytes,
            [r for r in ptxas_resources(log, SYMBOLS["range_filter_packed"])
             if f"<{width}," in r["function"]],
            ("words.clone()", torch.clone),
            lambda w: ops.range_filter_packed(w, width, lo, hi, tw),
            lambda w: packed_filter.packed_range_filter(
                ops._pad_to_tiles(w, tw, -1), lo, hi, width,
                tw)[0][:w.shape[0]]))

    # the bloom probe at the micro-bench's bloom, then the largest one; in
    # CUDA graphs hot and cold, with the registers and the SASS
    # instructions per key of its instantiations
    for key, where in (("bloom", "micro-bench"),
                       ("big", "the largest documented bloom")):
        words, nbits, keys = bench[key]
        # per hash: mix32 (9), the modulo, word and bit index, the bit test
        # and the AND into the hit (6)
        n_ops = keys.shape[0] * 6 * 15
        nbytes = 5 * keys.shape[0] + 4 * words.shape[0]
        rows.append(compare(
            "bloom_probe",
            lambda: bloom_probe.bloom_probe(words, nbits, keys),
            lambda: bloom_probe.bloom_probe_plain(words, nbits, keys),
            nbytes, bw, launches["bloom_probe"],
            f"bloom={words.shape[0]} words ({nbits} bits) keys={keys.shape[0]} "
            f"hashes=6 ({where})",
            op_bound_ms=n_ops / rates["int32_ops"] * 1e3))

        def probe(w, k, nbits=nbits):
            return bloom_probe.bloom_probe(w, nbits, k)

        # the same keys and words at an nbits that is not a power of two
        # (the largest prime below it): the magic-number remainder
        odd = next(p for p in range(nbits - 1, 1, -1)
                   if all(p % d for d in range(2, int(p ** 0.5) + 1)))
        check(torch.equal(bloom_probe.bloom_probe(words, odd, keys),
                          bloom_probe.bloom_probe_plain(words, odd, keys)),
              f"bloom_probe at nbits {odd} differs from plain")
        rows[-1].update({
            "main_path": key == "bloom", "int_ops": n_ops,
            "ptxas": ptxas_resources(log, SYMBOLS["bloom_probe"]),
            "sass": bloom_sass(sass),
            "graph_ms": hot_graph_ms(probe, words, keys),
            "cold_graph_ms": cold_graph_ms(probe, nbytes, words, keys),
            "odd_nbits": odd,
            "odd_nbits_cold_graph_ms": cold_graph_ms(
                functools.partial(probe, nbits=odd), nbytes, words, keys)})

    # the selective scan at falcon-mamba-7b's width: bytes of u, delta and
    # y (plus B, C, A and the state) against one exp per (b, t, d, n) at
    # the card's exp rate and 6 float32 operations per (b, t, d, n)
    u, dt, A, Bm, Cm = bench["ssm"]
    B, L, D, N = SSM_SHAPE
    elems = B * L * D * N
    exp_ms = elems / rates["exp_per_s"] * 1e3
    flop_ms = 6 * elems / rates["fp32_flops"] * 1e3
    rows.append(compare(
        "ssm_scan", lambda: ssm_scan.ssm_scan(u, dt, A, Bm, Cm),
        lambda: ssm_scan.ssm_scan_plain(u, dt, A, Bm, Cm),
        4 * (3 * B * L * D + 2 * B * L * N + D * N + B * D * N), bw,
        launches["ssm_scan"],
        f"B={B} L={L} D={D} N={N} (falcon-mamba-7b's d_inner and d_state)",
        tol=SSM_TOL, op_bound_ms=max(exp_ms, flop_ms), plain_reps=5))
    scan = ssm_scan.ssm_scan
    nbytes = rows[-1]["bytes"]
    rows[-1].update({"exps": elems, "exp_ms": exp_ms, "flops": 6 * elems,
                     "flop_ms": flop_ms,
                     "state_lanes": ssm_scan.scan_layout(N),
                     "states_per_lane": ssm_scan.STATES_PER_LANE,
                     "steps_per_round": ssm_scan.STEPS_PER_ROUND,
                     "ptxas": ptxas_resources(log, SYMBOLS["ssm_scan"]),
                     "graph_ms": hot_graph_ms(scan, u, dt, A, Bm, Cm),
                     "cold_graph_ms": cold_graph_ms(
                         scan, nbytes, u, dt, A, Bm, Cm)})
    # the same u and delta with other state dimensions, cold: the streams
    # and y stay while a channel's lanes grow with N
    gen = torch.Generator(device=u.device).manual_seed(1)
    sweep = {}
    for n in (1, 8, 32):
        a_n = -torch.rand((D, n), generator=gen, device=u.device)
        b_n, c_n = (torch.randn((B, L, n), generator=gen, device=u.device)
                    for _ in range(2))
        sweep[n] = cold_graph_ms(scan, nbytes, u, dt, a_n, b_n, c_n)
    rows[-1]["state_dim_cold_graph_ms"] = sweep
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1 << 23)
    ap.add_argument("--clustered-pairs", type=int, default=1 << 20)
    ap.add_argument("--fast-pairs", type=int, default=1 << 22,
                    help="pairs of the agg.fast tree (sequential keys)")
    ap.add_argument("--codec-pairs", type=int, default=1 << 20,
                    help="pairs of the codecs phase's five trees")
    ap.add_argument("--durable-pairs", type=int, default=1 << 20,
                    help="pairs of the durable phase's stream")
    ap.add_argument("--background-pairs", type=int, default=1 << 20,
                    help="pairs of the background phase's stream")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    bw = next(rate for key, rate in BANDWIDTH if key in device_name)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"sm_count": sms,
             "exp_per_s": EXP_PER_CLOCK_PER_SM * sms * max_mhz * 1e6,
             "int32_ops": INT32_PER_CLOCK_PER_SM * sms * max_mhz * 1e6,
             "fp32_flops": next(r for key, r in FP32_RATE if key in device_name)}

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log = Path(str(lib) + ".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bandwidth_Bps": bw, "sm_count": sms, "max_sm_clock_mhz": max_mhz,
          **rates, "ptxas": ptxas})

    recs = {
        # keyed by pack width, with the launches per width
        "pack": Recorder(ops.pack_codes, lambda c, w: c.shape[0],
                         lambda c, w: w),
        # keyed by pack width, with the launches per width
        "unpack": Recorder(ops.unpack_codes, lambda w, wd, n: n,
                           lambda w, wd, n: wd),
        "fused": Recorder(ops.fused_zone_filter,
                          lambda w, *a: w.shape[0], lambda w, m, r, wd, *a: wd),
        "remap": Recorder(ops.remap_pack_codes, lambda e, *a: e.shape[0],
                          lambda e, s, t, o, w: w),
        # recorded during agg.fast only
        "agg": Recorder(ops.fused_zone_agg, lambda w, *a: w.shape[0],
                        active=False),
        "hist": Recorder(ops.zone_histogram,
                         lambda w, m, e, wd, nb, *a: w.shape[0] * nb,
                         active=False),
        # recorded during the serve phases only
        "multi": Recorder(ops.multi_range_filter,
                          lambda w, r, *a: w.shape[0] * r.shape[0],
                          active=False),
        "codes": Recorder(ops.code_range_filter, lambda c, *a: c.shape[0],
                          active=False),
        # recorded during compact.jax only
        "remap_codes": Recorder(ops.remap_codes, lambda e, *a: e.shape[0],
                                active=False),
        # recorded during fig5 only
        "packed": Recorder(ops.packed_range_filter, lambda w, *a: w.shape[0],
                           active=False),
    }
    # compact.jax's packs (merge outputs among them), keyed by width
    recs["pack_compact"] = Recorder(recs["pack"], lambda c, w: c.shape[0],
                                    lambda c, w: w, active=False)
    ops.pack_codes, ops.unpack_codes = recs["pack_compact"], recs["unpack"]
    ops.fused_zone_filter, ops.remap_pack_codes = recs["fused"], recs["remap"]
    ops.fused_zone_agg, ops.zone_histogram = recs["agg"], recs["hist"]
    ops.multi_range_filter, ops.code_range_filter = recs["multi"], recs["codes"]
    ops.remap_codes, ops.packed_range_filter = (recs["remap_codes"],
                                                recs["packed"])
    launches, state = main_phase(args, "cuda")
    # the pack, unpack and remap rows replay the main path's own calls
    for key in ("pack", "unpack", "remap"):
        recs[key].active = False
    for key, kernel in (("unpack", "unpack_codes"), ("pack", "pack_codes"),
                        ("remap", "remap_pack_codes")):
        by_width = dict(sorted(recs[key].launches.items()))
        emit({"phase": f"main.{key}_by_width", kernel: by_width})
        check(sum(by_width.values()) == launches[kernel], f"{kernel} launches "
              f"by width {by_width} do not sum to {launches[kernel]}")
    launches.update(serve_phase(state, {k: recs[k]
                                        for k in ("multi", "codes")}))
    fast_launches = agg_phase(args, state,
                              {k: recs[k] for k in ("agg", "hist")}, "cuda")
    launches.update({k: fast_launches[k] for k in AGG_KERNELS})
    # the main path's operands stay those of the main tree's own ingest
    recs["fused"].active = False
    recs["remap_codes"].active = recs["pack_compact"].active = True
    launches["remap_codes"] = compact_phase(state, "jax",
                                            "cuda")["remap_codes"]
    recs["remap_codes"].active = recs["pack_compact"].active = False
    compact_phase(state, "numpy", "cuda")
    range_phase(args, state)
    launches["range_filter_packed"] = fig5_phase(state, recs)
    fig5_example("cuda")
    sync_ingest = codecs_phase(args, "cuda")
    durable_phase(args, "cuda")
    background_phase(args, recs, sync_ingest, "cuda")
    bench_launches, bench = bench_phase(args)
    launches.update({k: bench_launches[k] for k in ("bloom_probe", "ssm_scan")})
    rows = kernel_phase(recs, launches, bw, bench, rates, log,
                        sass_functions(lib))
    for r in rows:
        emit({"phase": "kernel", **r})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    print(card, flush=True)
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    # one row per kernel, and for the unpack one per pack width of the main
    # path: for the filter the largest level of the main path, for the
    # aggregate kernel its SUM launch of agg.fast, for the packed range
    # filter fig5's largest SCT, for the bloom probe the micro-bench's
    table = [{k: r[k] for k in keep} for r in rows if r.get("main_path", True)]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
