#!/usr/bin/env python3
"""Block shapes of the two single-range filter kernels on one CUDA card.

    python3 tools/filter_probe.py [--out build/filter_probe.jsonl]

It builds ``src/repro_torch/kernels/csrc/packed_filter.cu`` and
``opd_filter.cu`` on their own, once per variant, with the library's nvcc
flags (all builds started together): threads a block
(``REPRO_FILTER_THREADS``) 128 and 256, each with 16-byte loads a
thread in flight (``REPRO_FILTER_LOADS``) 4 and 8, the choice behind
``packed_filter.FILTER_THREADS`` and ``FILTER_LOADS``.  Every variant runs
at each cluster size (``packed_filter.CLUSTER_SIZES``) on:

* ``fig5``: 1,198,372 entries (the largest SCT of ``chip_smoke.py``'s main
  tree, 37 tiles of 32,768, the last partial), words of width 32 and
  codes in [-1, 403,041);
* ``bench``: 262,144 words of width 8 (the micro-bench's 2^20 codes);
* ``one_tile``: 1,000 entries, one partial tile (what a launch costs
  beside its bytes; timed hot only).

For each it checks the outputs against the plain versions bit for bit and
prints CUDA-graph times (``chip_smoke.hot_graph_ms``, operands in L2, and
``chip_smoke.cold_graph_ms``, a fresh copy every call) as JSON lines, with
the same traffic as one PyTorch copy beside them (``words.clone()``, 8
bytes a word; ``codes.to(torch.int8)``, 5 bytes a code) and the registers
of every variant.  The last line is the card as ``nvidia-smi`` names it,
with its power limit.  Exits non-zero when no card is available or a
variant differs from plain.

It also times what a launch costs beside its bytes (``overhead_graph_ms``):
blocks that store 64 bytes a thread and nothing more, launched plain and in
clusters of 8, then with the filters' cluster count
(``csrc/cluster_count.cuh``: asynchronous remote stores completing on rank
0's mbarrier), and with the count through a second cluster barrier phase
instead, at 8 and 296 blocks.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

THREADS = (256, 128)
LOADS = (4, 8)
SHAPES = {"fig5": (1_198_372, 32), "bench": (262_144, 8),
          "one_tile": (1_000, 32)}
SOURCES = {"range_filter_packed": "packed_filter.cu",
           "range_filter_codes": "opd_filter.cu"}

# what a launch costs beside its bytes: blocks of 256 threads that each
# store 64 bytes a thread (as the filters store their outputs), then: how 0,
# nothing more, launched plain; 1, the same in clusters of 8; 2, the
# filters' cluster count (cluster_count.cuh: slots sent with asynchronous
# remote stores that complete on rank 0's mbarrier); 3, the count through a
# second cluster barrier phase instead (each block's slot stored remotely,
# warp 0 arriving with release semantics, the other warps relaxed, every
# thread waiting, rank 0 reading the slots after the phase)
OVERHEAD_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_count.cuh"

template <int kHow>
__global__ void __launch_bounds__(256) overhead_kernel(int32_t* out,
                                                       uint4* scratch) {
  namespace cg = cooperative_groups;
  __shared__ unsigned s_warp[8];
  __shared__ unsigned s_part[8];
  __shared__ alignas(8) uint64_t s_bar;
  if constexpr (kHow == 2) repro::cluster_count_begin<8>(&s_bar);
  if constexpr (kHow == 3)
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  const uint64_t i = (uint64_t(blockIdx.x) * 256 + threadIdx.x) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) scratch[i + k] = make_uint4(k, k, k, k);
  if constexpr (kHow == 2) {
    repro::cluster_count<8, 256>(1u, 0u, out + blockIdx.x / 8, s_warp,
                                 s_part, &s_bar);
  } else if constexpr (kHow == 3) {
    const cg::cluster_group cluster = cg::this_cluster();
    unsigned got = __reduce_add_sync(0xFFFFFFFFu, 1u);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = got;
    __syncthreads();
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
    if (threadIdx.x == 0) {
      unsigned sum = 0;
      for (int w = 0; w < 8; ++w) sum += s_warp[w];
      *cluster.map_shared_rank(s_part + cluster.block_rank(), 0) = sum;
    }
    __syncwarp();
    if (threadIdx.x < 32)
      asm volatile("barrier.cluster.arrive;\n" ::: "memory");
    else
      asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
      unsigned sum = 0;
      for (int r = 0; r < 8; ++r) sum += s_part[r];
      out[blockIdx.x / 8] = static_cast<int32_t>(sum);
    }
  } else if (threadIdx.x == 0) {
    out[blockIdx.x] = 1;
  }
}

extern "C" int repro_overhead(int how, int blocks, void* out, void* scratch,
                              void* stream) {
  auto* o = static_cast<int32_t*>(out);
  auto* x = static_cast<uint4*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (how) {
    case 0:
      overhead_kernel<0><<<blocks, 256, 0, s>>>(o, x);
      return static_cast<int>(cudaGetLastError());
    case 1:
      return static_cast<int>(repro::launch_clusters<&overhead_kernel<1>, 8,
                                                     256>(blocks, s, o, x));
    case 2:
      return static_cast<int>(repro::launch_clusters<&overhead_kernel<2>, 8,
                                                     256>(blocks, s, o, x));
    default:
      return static_cast<int>(repro::launch_clusters<&overhead_kernel<3>, 8,
                                                     256>(blocks, s, o, x));
  }
}
"""


def build(out_dir: Path):
    """Every variant's shared library, compiled in parallel; and the
    registers and spill bytes of each variant's instantiations."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        for t in THREADS:
            for ld in LOADS:
                obj = out_dir / f"{name}_t{t}_l{ld}.o"
                procs[(name, t, ld)] = (obj, subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, f"-DREPRO_FILTER_THREADS={t}",
                     f"-DREPRO_FILTER_LOADS={ld}", "-c",
                     str(_build.CSRC / src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
    over_src = out_dir / "overhead.cu"
    over_src.write_text(OVERHEAD_CU)
    over_lib = out_dir / "overhead.so"
    over = subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared",
         str(over_src), "-o", str(over_lib)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    text, _ = over.communicate()
    if over.returncode:
        raise RuntimeError(f"nvcc failed for the overhead kernels:\n{text}")
    fn = ctypes.CDLL(str(over_lib)).repro_overhead
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    libs["overhead"] = fn
    for key, (obj, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        # linked as the library is: objects first, then one shared library
        lib = obj.with_suffix(".so")
        subprocess.run([nvcc, "-shared", "-o", str(lib), str(obj)],
                       check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(str(lib)), "repro_" + key[0])
        fn.argtypes = _build._SIGNATURES["repro_" + key[0]]
        fn.restype = ctypes.c_int
        libs[key] = fn
        regs[key] = sorted({int(m.group(1)) for m in re.finditer(
            r"Used (\d+) registers", text)})
        spills = [int(m.group(1)) for m in re.finditer(
            r"(\d+) bytes spill stores", text)]
        if any(spills):
            regs[key].append(f"spills {max(spills)} B")
    return libs, regs


def packed_call(fn, width: int, lo: int, hi: int, tile: int, cluster: int):
    import torch

    def call(words):
        bitmap = torch.empty_like(words)
        counts = torch.empty(-(-words.shape[0] // tile), dtype=torch.int32,
                             device=words.device)
        rc = fn(words.data_ptr(), lo, hi, bitmap.data_ptr(),
                counts.data_ptr(), words.shape[0], tile, width, cluster,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"range_filter_packed variant failed: {rc}")
        return bitmap, counts
    return call


def codes_call(fn, lo: int, hi: int, tile: int, cluster: int):
    import torch

    def call(codes):
        mask = torch.empty(codes.shape[0], dtype=torch.int8,
                           device=codes.device)
        counts = torch.empty(-(-codes.shape[0] // tile), dtype=torch.int32,
                             device=codes.device)
        rc = fn(codes.data_ptr(), lo, hi, mask.data_ptr(), counts.data_ptr(),
                codes.shape[0], tile, cluster,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"range_filter_codes variant failed: {rc}")
        return mask, counts
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "filter_probe.jsonl")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("filter_probe: no CUDA card available", file=sys.stderr)
        return 2
    from chip_smoke import cold_graph_ms, hot_graph_ms
    from repro_torch.kernels import opd_filter, packed_filter

    libs, regs = build(ROOT / "build" / "filter_probe")
    tile = packed_filter.DEFAULT_TILE_WORDS
    rng = np.random.default_rng(0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    lines, ok = [], True
    for shape, (n, width) in SHAPES.items():
        words = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                                 .astype(np.int32)).cuda()
        codes = torch.from_numpy(rng.integers(-1, 403_041, n)
                                 .astype(np.int32)).cuda()
        w_lo, w_hi = (1, 200) if width < 32 else (0x40000000, 0x4FFFFFFF)
        c_lo, c_hi = 1_000, 26_000
        cases = {
            "range_filter_packed": (
                words, 8 * n,
                functools.partial(packed_call, width=width, lo=w_lo, hi=w_hi,
                                  tile=tile),
                functools.partial(packed_filter.packed_range_filter_plain,
                                  lo=w_lo, hi=w_hi, width=width,
                                  tile_words=tile),
                ("words.clone()", torch.clone)),
            "range_filter_codes": (
                codes, 5 * n,
                functools.partial(codes_call, lo=c_lo, hi=c_hi, tile=tile),
                functools.partial(opd_filter.code_range_filter_plain,
                                  lo=c_lo, hi=c_hi, tile_codes=tile),
                ("codes.to(torch.int8)", lambda c: c.to(torch.int8)))}
        for name, (x, nbytes, make, plain, (yname, yard)) in cases.items():
            want = plain(x)
            cold = cold_graph_ms if shape != "one_tile" else \
                (lambda *a: None)
            row = {"shape": shape, "kernel": name, "n": n, "width": width,
                   "bytes": nbytes, "yardstick": yname,
                   "yardstick_graph_ms": hot_graph_ms(yard, x),
                   "yardstick_cold_graph_ms": cold(yard, nbytes, x),
                   "variants": []}
            for key, fn in libs.items():
                if key[0] != name:
                    continue
                _, t, ld = key
                for c in packed_filter.CLUSTER_SIZES:
                    call = make(fn, cluster=c)
                    try:
                        got = call(x)
                    except RuntimeError as e:
                        ok = False
                        row["variants"].append({"threads": t, "loads": ld,
                                                "cluster": c,
                                                "error": str(e)})
                        continue
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                    ok &= same
                    row["variants"].append({
                        "threads": t, "loads": ld, "cluster": c,
                        "grid": -(-n // tile) * c, "equal_to_plain": same,
                        "graph_ms": hot_graph_ms(call, x),
                        "cold_graph_ms": cold(call, nbytes, x)})
            lines.append(row)
            print(json.dumps(row), flush=True)
    over = {}
    out = torch.empty(1024, dtype=torch.int32, device="cuda")
    scratch = torch.empty(296 * 256 * 16, dtype=torch.int32, device="cuda")
    for how, what in enumerate(("plain launch", "clusters of 8",
                                "clusters of 8 with the count",
                                "clusters of 8, count through a barrier")):
        for blocks in (8, 296):
            def launch(o, how=how, blocks=blocks):
                rc = libs["overhead"](how, blocks, o.data_ptr(),
                                      scratch.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"overhead kernel failed: {rc}")
            over[f"{what}, {blocks} blocks"] = hot_graph_ms(launch, out)
    print(json.dumps({"overhead_graph_ms": over}), flush=True)
    lines.append({"overhead_graph_ms": over})
    reg = {f"{k[0]} threads={k[1]} loads={k[2]}": v for k, v in regs.items()}
    print(json.dumps({"registers": reg}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(args.out, "w") as f:
        for row in lines + [{"registers": reg}, {"card": card}]:
            f.write(json.dumps(row) + "\n")
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
