#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: one card, ~8.4 M pairs

Phases, each printing JSON lines:

1. build:   nvcc builds the four CUDA kernels from ``src/repro_torch``;
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
            after; each of the four kernels must have launched.
3. kernels: each kernel against its plain PyTorch version on the card, on
            operands recorded from the main path (bit-identical required),
            with CUDA-event medians, the plain version's time and the
            memory-bound time from the card's data-sheet bandwidth.

The last three lines are the card (nvidia-smi name, power limit), the
kernel table ``{"kernels": [...]}`` and ``{"ok": true, "device": ...}``.
Any mismatch or error exits non-zero before them.  The script imports
only torch, numpy and the port; it exits non-zero with no result when no
CUDA card is available or when it stands outside the repository.
"""

from __future__ import annotations

import argparse
import json
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

KERNELS = {
    "pack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                   "src/repro/kernels/bitpack.py:57"),
    "unpack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                     "src/repro/kernels/bitpack.py:75"),
    "fused_zone_filter": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                          "src/repro/kernels/fused_scan.py:115"),
    "remap_pack_codes": ("src/repro_torch/kernels/csrc/merge_remap.cu",
                         "src/repro/kernels/merge_remap.py:141"),
}
SYMBOLS = {"pack_codes": "pack_codes_kernel",
           "unpack_codes": "unpack_codes_kernel",
           "fused_zone_filter": "fused_zone_filter_kernel",
           "remap_pack_codes": "remap_pack_kernel"}
NO_LIBRARY = ("no single PyTorch call computes this bit-field function; "
              "its plain version is several calls")


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
    n_match = 0
    for (kind, a, b), r in zip(preds, got):
        keys, vals = ref.filter(kind, a, b)
        check(np.array_equal(r.keys, keys),
              f"{label}: filter {kind} {a!r} {b!r} keys differ "
              f"({r.keys.shape[0]} vs {keys.shape[0]})")
        check(r.values.tolist() == vals.tolist(),
              f"{label}: filter {kind} {a!r} values differ")
        n_match += int(keys.shape[0])
    return {"filter_many_s": dt, "k": len(preds), "rows_matched": n_match}


def run_get_check(tree, ref: Reference, keys: np.ndarray, label: str) -> dict:
    t0 = time.perf_counter()
    for k in keys.tolist():
        want = ref.get(k)
        got = tree.get(k)
        check(got == want,
              f"{label}: get({k}) = {got!r}, expected {want!r}")
    return {"gets": int(keys.shape[0]),
            "get_us": (time.perf_counter() - t0) / max(1, keys.shape[0]) * 1e6}


def main_phase(args, device: str) -> dict:
    """Uniform phase then clustered phase; returns the launch counts."""
    import torch
    from repro_torch import LSMConfig, LSMTree, Predicate
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed)
    width, n = 256, args.pairs
    cfg = LSMConfig(key_bytes=16, value_width=width, file_bytes=32 * 2**20,
                    size_ratio=10, l0_limit=4)
    ndv = max(1, int(n * 0.01))
    vocab = make_vocab(ndv, width, rng)
    keys = rng.integers(0, 4 * n, n, dtype=np.uint64)
    vidx = rng.integers(0, ndv, n)
    emit({"phase": "main", "reduced": "pairs 6.4e7 -> %.1e (host-side memtable "
          "ingest within the smoke's time limit)" % n, "pairs": n,
          "value_width": width, "ndv": ndv, "file_bytes": cfg.file_bytes})

    ops.reset_launches()
    tree = LSMTree(cfg, device=device)
    ref = Reference(vocab)
    t0 = time.perf_counter()
    batch = 1 << 20
    for i in range(0, n, batch):
        tree.put_batch(keys[i:i + batch], vocab[vidx[i:i + batch]])
        ref.put(keys[i:i + batch], vidx[i:i + batch])
    n_del = max(1, n // 512)
    dels = rng.choice(keys, n_del, replace=False)
    for k in dels.tolist():
        tree.delete(k)
    ref.delete(dels)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    shape = tree.shape_report()
    widths = sorted({s.code_bits for s in tree.all_runs()})
    emit({"phase": "main.ingest", "ops": n + n_del, "seconds": ingest_s,
          "ops_per_s": (n + n_del) / ingest_s,
          "flush_s": tree.flush_stats.total(),
          "compaction_s": tree.compaction_stats.total(),
          "compaction_stages_s": dict(tree.compaction_stats.seconds),
          "n_flushes": shape["n_flushes"], "n_compactions": shape["n_compactions"],
          "levels": shape["levels"], "pack_widths": widths,
          "dict_sizes": sorted({s.opd.size for s in tree.all_runs()})[-3:],
          "disk_bytes": shape["disk_bytes"]})

    preds = [("prefix", b"cat_%05d_" % (37 * i + 5), b"") for i in range(11)]
    preds += [("range", b"cat_00100_", b"cat_00104_\xff"),
              ("eq", bytes(vocab[ndv // 2]).rstrip(b"\x00"), b""),
              ("ge", b"cat_00996_", b""), ("le", b"", b"cat_00002_\xff"),
              ("prefix", b"zzz", b"")]
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
        (ck // 4).astype(np.int64).astype("S12"), 12)).astype(f"S{width}")
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
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
    return launches


# --------------------------------------------------------------------------- #
# kernels against their plain versions, on operands the main path produced
# --------------------------------------------------------------------------- #
class Recorder:
    """Wraps an ops entry point; keeps the operands of its largest call
    (per key) so the kernel phase can replay the main path's shapes."""

    def __init__(self, fn, size, key=lambda *a, **k: 0):
        self.fn, self.size, self.key, self.calls = fn, size, key, {}

    def __call__(self, *args, **kw):
        key = self.key(*args, **kw)
        old = self.calls.get(key)
        if old is None or self.size(*args, **kw) > self.size(*old[0], **old[1]):
            self.calls[key] = (args, kw)
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


def profiled_device_ms(fn, symbol: str, reps: int = 20):
    """Mean device time of the kernel ``symbol`` over ``reps`` calls, from
    torch.profiler's CUDA activity; None when the trace has no such kernel."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(r"(^|[^A-Za-z_])" + symbol + r"\b")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is not None and pat.search(e.key):
            total += dt
            count += e.count
    return total / count / 1e3 if count else None


def compare(name: str, kernel, plain, nbytes: int, bw: float, launches: int,
            shape: str) -> dict:
    import torch
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    check(ops.LAUNCHES[name] > before[name], f"{name}: kernel did not launch")
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: shape/dtype {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    check(err == 0, f"{name} ({shape}): kernel differs from plain, max |err| {err}")
    ms = event_median_ms(kernel, inner=10)
    plain_ms = event_median_ms(plain, inner=1, warmup=1)
    src, rep = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": profiled_device_ms(kernel, SYMBOLS[name]),
            "plain_ms": plain_ms, "bound_ms": nbytes / bw * 1e3,
            "bytes": nbytes,
            "bound_by": "bytes", "library_ms": None, "library_why": NO_LIBRARY,
            "shape": shape}


def kernel_phase(recs, launches: dict, bw: float) -> list:
    import torch
    from repro_torch.kernels import bitpack, fused_scan, merge_remap

    rows = []
    (codes, width), _ = recs["pack"].calls[0]
    n = codes.shape[0]
    m = bitpack.n_words_for(n, width)
    rows.append(compare(
        "pack_codes", lambda: bitpack.pack_codes(codes, width),
        lambda: bitpack.pack_codes_plain(codes, width), 4 * n + 4 * m, bw,
        launches["pack_codes"], f"n={n} width={width}"))

    (words, width, n), _ = recs["unpack"].calls[0]
    rows.append(compare(
        "unpack_codes", lambda: bitpack.unpack_codes(words, width, n),
        lambda: bitpack.unpack_codes_plain(words, width, n),
        4 * words.shape[0] + 4 * n, bw, launches["unpack_codes"],
        f"n={n} width={width}"))

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
        rows[-1]["main_path"] = w0 == width and fw is biggest[0][0]

    (evs, srcs, table, offsets, width), _ = recs["remap"].calls[0]
    n = evs.shape[0]
    m = bitpack.n_words_for(n, width)
    rows.append(compare(
        "remap_pack_codes",
        lambda: merge_remap.remap_pack_codes(evs, srcs, table, offsets, width),
        lambda: merge_remap.remap_pack_codes_plain(evs, srcs, table, offsets,
                                                   width),
        8 * n + 4 * m + 4 * table.shape[0] + 4 * offsets.shape[0], bw,
        launches["remap_pack_codes"],
        f"n={n} width={width} table={table.shape[0]} sources={offsets.shape[0]}"))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1 << 23)
    ap.add_argument("--clustered-pairs", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    name = torch.cuda.get_device_name(0)
    bw = next(rate for key, rate in BANDWIDTH if key in name)

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    ptxas = [ln.strip() for ln in Path(str(lib) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bandwidth_Bps": bw, "ptxas": ptxas})

    recs = {
        "pack": Recorder(ops.pack_codes, lambda c, w: c.shape[0]),
        "unpack": Recorder(ops.unpack_codes, lambda w, wd, n: n),
        "fused": Recorder(ops.fused_zone_filter,
                          lambda w, *a: w.shape[0], lambda w, m, r, wd, *a: wd),
        "remap": Recorder(ops.remap_pack_codes, lambda e, *a: e.shape[0]),
    }
    ops.pack_codes, ops.unpack_codes = recs["pack"], recs["unpack"]
    ops.fused_zone_filter, ops.remap_pack_codes = recs["fused"], recs["remap"]
    launches = main_phase(args, "cuda")
    rows = kernel_phase(recs, launches, bw)
    for r in rows:
        emit({"phase": "kernel", **r})

    print(card, flush=True)
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # one row per kernel; for the filter, the largest level of the main path
    table = [{k: r[k] for k in keep} for r in rows
             if r["name"] != "fused_zone_filter" or r.get("main_path")]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
