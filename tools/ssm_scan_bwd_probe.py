#!/usr/bin/env python3
"""How ``ssm_scan_bwd``'s kernel fares under its build constants, on one
CUDA card: the choice behind ``ssm_scan.BWD_STATES``, ``BWD_STEPS``,
``BWD_ROUND``, ``BWD_THREADS`` and ``BWD_BLOCKS``.

    python3 tools/ssm_scan_bwd_probe.py [--out chiprun_out/ssm_bwd_probe.json]
                                        [--variants 4,8,4,128,4 2,8,4,128,4 ...]

It builds ``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu`` on its own once
per variant, with the library's nvcc flags and the variant's states a lane
(``REPRO_SSM_BWD_STATES``), steps between checkpoints
(``REPRO_SSM_BWD_STEPS``), steps a round (``REPRO_SSM_BWD_ROUND``),
threads a block (``REPRO_SSM_BWD_THREADS``, so channels a block) and
blocks an SM holds by registers (``REPRO_SSM_BWD_BLOCKS``), all builds
started together, and runs each through the library's wrapper
(``ssm_scan.ssm_scan_bwd``, its layout rule under the variant's
constants) on bf16 u, delta, B and C and float32 A and dy, as the model
path hands them over.  It prints JSON lines:

* ``ptxas``: registers, spill bytes and stack of every variant's
  instantiations at the shapes' lane count (G 4 at N 16);
* ``times``: cold CUDA-graph times (``chip_smoke.cold_graph_ms``, each
  copy of the operands with their strides, so the kernel reads them in
  place as on the model path) of one
  wrapper call of every variant at hymba-1.5b's first layer in ``train``
  (B 2, L 1,024, D 3,200, N 16) and at falcon-mamba-7b's width (B 2, L
  1,024, D 8,192, N 16), beside each shape's bound (two exps a (b, t, d,
  n) at the card's exp rate, or the bytes over its bandwidth) and the
  variant's layout of it;
* ``accuracy``: at hymba's shape with A as drawn and scaled by 0.05
  (decays near 1), each variant's worst output against the plain version
  (of each output's largest magnitude; the contract is 1e-4), whether a
  rerun gives the same bits and whether bf16 operands give the bits of
  their float32 copies.

The last line is the card as ``nvidia-smi`` names it, with its power
limit.  Exits non-zero when no card is available.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = {"hymba": (2, 1024, 3200, 16), "falcon": (2, 1024, 8192, 16)}
# (states a lane, steps between checkpoints, steps a round, threads a block)
# and blocks an SM holds by registers)
VARIANTS = [(4, 8, 4, 128, 4), (4, 8, 8, 128, 4), (4, 4, 4, 128, 4),
            (4, 8, 4, 128, 3), (4, 16, 8, 128, 3), (2, 8, 4, 128, 4),
            (2, 16, 8, 128, 4), (2, 16, 8, 128, 3), (4, 8, 4, 256, 2)]
NAMES = ("BWD_STATES", "BWD_STEPS", "BWD_ROUND", "BWD_THREADS", "BWD_BLOCKS")
FLAGS = ("REPRO_SSM_BWD_STATES", "REPRO_SSM_BWD_STEPS",
         "REPRO_SSM_BWD_ROUND", "REPRO_SSM_BWD_THREADS",
         "REPRO_SSM_BWD_BLOCKS")
TOL = 1e-4
ERROR_CU = r"""
#include <cuda_runtime.h>
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def tag(v) -> str:
    return "states={} steps={} round={} threads={} blocks={}".format(*v)


def build(out_dir: Path, variants) -> tuple:
    """Every variant's shared library, compiled in parallel, and the
    -Xptxas=-v resources of its kernel's instantiations."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    err_src = out_dir / "error_string.cu"
    err_src.write_text(ERROR_CU)
    src = _build.CSRC / "ssm_scan_bwd.cu"
    procs = {}
    for v in variants:
        lib = out_dir / f"bwd_{'_'.join(map(str, v))}.so"
        flags = [f"-D{f}={x}" for f, x in zip(FLAGS, v)]
        procs[v] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", str(src),
             str(err_src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, res = {}, {}
    for v, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {tag(v)}:\n{text}")
        libs[v] = lib
        res[tag(v)] = ptxas(text)
    return libs, res


def ptxas(text: str) -> dict:
    """{instantiation: registers, spills, stack} of ssm_scan_bwd_kernel
    from nvcc's -Xptxas=-v output (mangled: T is f or 13__nv_bfloat16)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln) or \
            re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1) if "ssm_scan_bwd_kernel" in m.group(1) else None
            continue
        if cur is None:
            continue
        k = re.search(r"I(f|13__nv_bfloat16)Li(\d+)E", cur)
        key = (f"{'f32' if k.group(1) == 'f' else 'bf16'} G={k.group(2)}"
               if k else cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(key, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def load(path: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    lib.repro_ssm_scan_bwd.argtypes = _build._SIGNATURES["repro_ssm_scan_bwd"]
    lib.repro_ssm_scan_bwd.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Variant:
    """The library's wrapper with a variant's library and constants."""

    def __init__(self, v, lib):
        self.v, self.lib = v, lib

    def __call__(self, *ops):
        from repro_torch.kernels import _build, ssm_scan

        saved = [getattr(ssm_scan, n) for n in NAMES], _build._lib
        for n, x in zip(NAMES, self.v):
            setattr(ssm_scan, n, x)
        _build._lib = self.lib
        try:
            return ssm_scan.ssm_scan_bwd(*ops)
        finally:
            for n, x in zip(NAMES, saved[0]):
                setattr(ssm_scan, n, x)
            _build._lib = saved[1]

    def layout(self, shape):
        from repro_torch.kernels import ssm_scan

        saved = [getattr(ssm_scan, n) for n in NAMES]
        for n, x in zip(NAMES, self.v):
            setattr(ssm_scan, n, x)
        try:
            return ssm_scan.bwd_layout(*shape)
        finally:
            for n, x in zip(NAMES, saved):
                setattr(ssm_scan, n, x)


def operands(shape, seed: int, a_scale: float = 1.0):
    """bf16 u, delta, B, C as the mamba block hands them over (u laid out
    steps first, as its causal conv leaves it; B and C strided slices of
    one projection behind hymba-1.5b's 100 columns of dt), float32 A and
    dy."""
    import torch

    B, L, D, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((B, D, L), generator=gen, device="cuda").transpose(1, 2)
    dt = torch.randn((B, L, D), generator=gen, device="cuda").abs() * 0.1
    A = -torch.randn((D, N), generator=gen, device="cuda").abs() * a_scale
    proj = torch.randn((B, L, 100 + 2 * N), generator=gen, device="cuda")
    dy = torch.randn((B, L, D), generator=gen, device="cuda")
    proj = proj.to(torch.bfloat16)
    return (u.to(torch.bfloat16), dt.to(torch.bfloat16), A,
            proj[..., 100:100 + N], proj[..., 100 + N:], dy)


def bound_ms(shape, rates: dict, bw: float) -> dict:
    B, L, D, N = shape
    exp_ms = 2 * B * L * D * N / rates["exp_per_s"] * 1e3
    nbytes = B * L * D * (2 + 2 + 4 + 4 + 4)   # bf16 u, delta; dy, du, ddelta
    return {"bound_ms": max(exp_ms, nbytes / bw * 1e3), "exp_ms": exp_ms,
            "bytes": nbytes, "bytes_ms": nbytes / bw * 1e3}


def accuracy(calls: dict, seed: int) -> list:
    import torch
    from repro_torch.kernels import ssm_scan

    rows = []
    for scale in (1.0, 0.05):
        ops = operands(SHAPES["hymba"], seed, scale)
        f32 = [t.float().contiguous() if t.dtype == torch.bfloat16 else t
               for t in ops]
        want = ssm_scan.ssm_scan_bwd_plain(*f32)
        row = {"a_scale": scale}
        for name, call in calls.items():
            got = call(*ops)
            again = call(*ops)
            copies = call(*f32)
            torch.cuda.synchronize()
            rel = max(float((g - w).abs().max()) /
                      max(float(w.abs().max()), 1e-30)
                      for g, w in zip(got, want))
            row[name] = {
                "worst_rel_err": rel, "within_tol": rel <= TOL,
                "rerun_bit_equal": all(torch.equal(a, b)
                                       for a, b in zip(got, again)),
                "bf16_equals_f32_copies": all(torch.equal(a, b)
                                              for a, b in zip(got, copies))}
            del got, again, copies
        rows.append(row)
        del ops, f32, want
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "ssm_bwd_probe.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="states,steps,round,threads,blocks each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import ssm_scan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True
    ).stdout.strip().splitlines()[0]
    variants = [tuple(int(x) for x in s.split(",")) for s in args.variants] \
        if args.variants else VARIANTS
    library = tuple(getattr(ssm_scan, n) for n in NAMES)
    if library not in variants:
        variants.insert(0, library)
    libs, res = build(ROOT / "build" / "ssm_bwd_probe", variants)
    calls = {tag(v): Variant(v, load(libs[v])) for v in variants}
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], stdout=subprocess.PIPE, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from repro_torch.launch import card as card_rates
    rates = {"exp_per_s": card_rates.EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6}
    bw = card_rates.rate(card_rates.BANDWIDTH, torch.cuda.get_device_name(0))
    results = []

    def emit(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"phase": "ptxas", "library": tag(library), "by_variant": res})
    for shape_name, shape in SHAPES.items():
        ops = operands(shape, args.seed)
        nbytes = bound_ms(shape, rates, bw)["bytes"]
        times, layouts = {}, {}
        for name, call in calls.items():
            try:
                times[name] = chip_smoke.cold_graph_ms(
                    call, nbytes, *ops, keep_strides=True)
            except RuntimeError as e:     # a layout the variant cannot take
                times[name] = f"failed: {e}"
            lay = call.layout(shape)
            layouts[name] = {"lanes": lay.lanes, "channels": lay.channels,
                             "d_blocks": lay.d_blocks, "blocks": lay.blocks}
        emit({"phase": "times", "shape": shape_name, "shape_BLDN": list(shape),
              **bound_ms(shape, rates, bw), "cold_graph_ms": times,
              "layouts": layouts})
        del ops
        torch.cuda.empty_cache()
    emit({"phase": "accuracy", "tol": TOL, "shape_BLDN":
          list(SHAPES["hymba"]), "rows": accuracy(calls, args.seed)})
    print(card, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "results": results},
                                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
