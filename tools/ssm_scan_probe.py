#!/usr/bin/env python3
"""Where ``ssm_scan``'s kernel spends its time, and how close it stays to
the plain version, on one CUDA card.

    python3 tools/ssm_scan_probe.py [--out chiprun_out/ssm_probe.json]

It builds ``src/repro_torch/kernels/csrc/ssm_scan.cu`` on its own, once
per variant, with the library's nvcc flags (all builds started together):

* states per lane (``REPRO_SSM_STATES``) 2, 4 and 8, each with rounds
  (``REPRO_SSM_ROUND``) of 4, 8 and 16 steps, the library's layout rule
  otherwise: the choice behind ``ssm_scan.STATES_PER_LANE`` and
  ``ssm_scan.STEPS_PER_ROUND``;
* at the library's states and round, the two diagnostic splits
  (``REPRO_SSM_SPLIT``): 1 keeps the staging and the y stores and drops
  the recurrence, 2 keeps the recurrence and drops the staging;

and a micro-kernel that times chains of FFMA, ``expf`` and ``ex2.approx``
per clock per SM at 4 to 32 warps an SM (clock64 in the kernel).

It prints JSON lines:

* ``rates``: the three rates, and the time 268,435,456 ``expf`` (one per
  element at falcon-mamba-7b's mixer, B 1, L 2,048, D 8,192, N 16) take
  at the best of them on every SM at the card's top clock;
* ``ptxas``: registers and spill bytes of every variant's instantiations;
* ``sass``: per element, the instructions of the kernel's round loop (the
  innermost loop that holds MUFU.EX2) at the library's states and round
  and falcon's G, by opcode, from ``cuobjdump -sass``;
* ``times``: cold CUDA-graph times (``chip_smoke.cold_graph_ms``) of every
  variant at falcon's shape, at batch 8 and at a quarter of its channels;
* ``accuracy``: at falcon's shape with A as drawn and scaled by 0.05
  (decays near 1), each variant against the plain version (the count of
  elements outside rtol = atol = 1e-4, the worst |err| over that bound)
  and, beside the plain version, against a float64 run of the same
  recurrence on the card; whether the final state equals the plain
  version's bit for bit.

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

FALCON = (1, 2048, 8192, 16)
SHAPES = {"falcon": FALCON, "batch8": (8, 2048, 8192, 16),
          "quarter": (1, 2048, 2048, 16)}
TOL = 1e-4

RATES_CU = r"""
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

template <int KIND>
__global__ void rate_kernel(float* out, long long* cycles, int iters) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.5f + 1e-3f * (threadIdx.x % 7 + j);
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (KIND == 0) v[j] = fmaf(v[j], 0.999f, 1e-4f);
      if constexpr (KIND == 1) v[j] = expf(-v[j]);
      if constexpr (KIND == 2)
        asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(v[j]) : "f"(-v[j]));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += v[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// kind 0 FFMA, 1 expf, 2 ex2.approx; one block of 32 * warps threads an
// SM; returns the operations per clock of the median block
extern "C" double repro_rate(int kind, int warps, int sms, int iters) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, sizeof(float) * sms * 32 * warps);
  cudaMalloc(&cyc, sizeof(long long) * sms);
  auto k = kind == 0 ? rate_kernel<0> : kind == 1 ? rate_kernel<1>
                                                  : rate_kernel<2>;
  k<<<sms, 32 * warps>>>(out, cyc, iters);   // warm-up
  k<<<sms, 32 * warps>>>(out, cyc, iters);
  long long* host = new long long[sms];
  cudaMemcpy(host, cyc, sizeof(long long) * sms, cudaMemcpyDeviceToHost);
  std::nth_element(host, host + sms / 2, host + sms);
  const long long median = host[sms / 2];
  delete[] host;
  cudaFree(out);
  cudaFree(cyc);
  return cudaGetLastError() == cudaSuccess
             ? 32.0 * warps * 8.0 * iters / static_cast<double>(median)
             : -1.0;
}
"""


def build(out_dir: Path) -> dict:
    """Every variant's shared library, compiled in parallel."""
    from repro_torch.kernels import _build, ssm_scan

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "ssm_scan.cu"
    rates_src = out_dir / "rates.cu"
    rates_src.write_text(RATES_CU)
    base = list(_build.NVCC_FLAGS)
    jobs = {name: (src, [f"-DREPRO_SSM_STATES={st}", f"-DREPRO_SSM_ROUND={rd}",
                         f"-DREPRO_SSM_SPLIT={split}"])
            for name, (st, rd, split) in variants().items()}
    jobs["rates"] = (rates_src, [])
    procs = {}
    for name, (path, extra) in jobs.items():
        lib = out_dir / f"{re.sub('[= ]', '', name)}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *base, *extra, "-shared", str(path), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = lib
        # -Xptxas=-v: registers and spill bytes of each G instantiation
        for m in re.finditer(r"ssm_scan_kernelILi(\d+)E.*?spill stores, "
                             r"(\d+) bytes spill loads.*?Used (\d+) "
                             r"registers", text, re.S):
            regs.setdefault(name, {})[int(m.group(1))] = {
                "registers": int(m.group(3)), "spill_load_bytes":
                int(m.group(2))}
    return libs, regs


def variants() -> dict:
    """name -> (states a lane, steps a round, split) of every build; the
    library's own is ``states=S round=R``."""
    from repro_torch.kernels import ssm_scan

    st, rd = ssm_scan.STATES_PER_LANE, ssm_scan.STEPS_PER_ROUND
    out = {f"states={s} round={r}": (s, r, 0) for s in (2, 4, 8)
           for r in (4, 8, 16)}
    out.update({f"split={k}": (st, rd, k) for k in (1, 2)})
    return out


def load_scan(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_ssm_scan
    fn.argtypes = _scan_signature()
    fn.restype = ctypes.c_int
    return fn


def _scan_signature():
    from repro_torch.kernels import _build

    return _build._SIGNATURES["repro_ssm_scan"]


def scan_call(fn, states: int):
    """A callable (u, dt, A, B, C) -> y that launches ``fn``, a variant
    built with ``states`` states a lane, in the library's layout rule."""
    import torch

    def call(u, dt, A, Bm, Cm):
        bt, length, d = u.shape
        n = A.shape[1]
        g = min(32, 1 << max(0, -(-n // states) - 1).bit_length())
        y = torch.empty_like(u)
        state = torch.empty((bt, d, n), dtype=torch.float32, device=u.device)
        rc = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(), bt, length, d,
                n, g, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ssm_scan variant launch failed: {rc}")
        return y, state
    return call


def operands(shape, seed: int, a_scale: float = 1.0):
    import torch

    B, L, D, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((B, L, D), generator=gen, device="cuda")
    dt = torch.randn((B, L, D), generator=gen, device="cuda").abs() * 0.1
    A = -torch.randn((D, N), generator=gen, device="cuda").abs() * a_scale
    Bm = torch.randn((B, L, N), generator=gen, device="cuda")
    Cm = torch.randn((B, L, N), generator=gen, device="cuda")
    return u, dt, A, Bm, Cm


def scan_f64(u, dt, A, Bm, Cm):
    """The recurrence in float64 on the card."""
    import torch

    u, dt, A, Bm, Cm = (t.double() for t in (u, dt, A, Bm, Cm))
    x = torch.zeros((u.shape[0], u.shape[2], A.shape[1]), dtype=torch.float64,
                    device=u.device)
    y = torch.empty(u.shape, dtype=torch.float64, device=u.device)
    for t in range(u.shape[1]):
        d = dt[:, t, :, None]
        x = torch.exp(d * A) * x + (d * u[:, t, :, None]) * Bm[:, t, None, :]
        y[:, t] = (x * Cm[:, t, None, :]).sum(dim=-1)
    return y, x


def rates(lib_path: Path, sms: int, mhz: float) -> dict:
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_rate.argtypes = [ctypes.c_int] * 4
    lib.repro_rate.restype = ctypes.c_double
    out = {}
    for kind, name in ((0, "ffma"), (1, "expf"), (2, "ex2")):
        iters = 4000 if kind else 20000
        out[name] = {w: lib.repro_rate(kind, w, sms, iters)
                     for w in (4, 8, 16, 32)}
    elems = FALCON[0] * FALCON[1] * FALCON[2] * FALCON[3]
    best = max(out["expf"].values())
    return {"per_clock_per_sm": out, "sms": sms, "max_sm_clock_mhz": mhz,
            "falcon_expf": elems,
            "falcon_expf_ms_at_best_rate": elems / (best * sms * mhz * 1e6)
            * 1e3}


def sass_counts(lib_path: Path, g: int, states: int, steps: int) -> dict:
    """Per element, the opcodes of the innermost loop of the kernel at G
    = ``g`` that holds a MUFU.EX2."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    want = f"ssm_scan_kernelILi{g}E"
    body = next((f for f in funcs if f.split("\n", 1)[0].find(want) >= 0),
                None)
    if body is None:
        return {"error": f"no function {want} in the SASS"}
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);", body):
        ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    best = None
    for addr, op, args in ins:
        t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            loop = [o for a, o, _ in ins if lo <= a <= addr]
            if any(o.startswith("MUFU.EX2") for o in loop) and \
                    (best is None or len(loop) < len(best)):
                best = loop
    if best is None:
        return {"error": "no loop with MUFU.EX2"}
    elems = steps * states
    hist = {}
    for o in best:
        hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
    return {"g": g, "states_per_lane": states, "steps_per_round": steps,
            "loop_instructions": len(best),
            "elements_per_iteration": elems,
            "per_element": round(len(best) / elems, 3),
            "per_element_by_opcode": {k: round(v / elems, 3) for k, v in
                                      sorted(hist.items(),
                                             key=lambda kv: -kv[1])}}


def accuracy(calls: dict, seed: int) -> list:
    import torch
    from repro_torch.kernels import ssm_scan

    rows = []
    for scale in (1.0, 0.05):
        ops_ = operands(FALCON, seed, scale)
        py, ps = ssm_scan.ssm_scan_plain(*ops_)
        fy, fs = scan_f64(*ops_)
        row = {"a_scale": scale, "plain_vs_float64": {
            "y": float((py.double() - fy).abs().max()),
            "state": float((ps.double() - fs).abs().max())}}
        for name, call in calls.items():
            ky, ks = call(*ops_)
            torch.cuda.synchronize()
            over = [((k - p).abs() / (TOL + TOL * p.abs()))
                    for k, p in ((ky, py), (ks, ps))]
            row[name] = {
                "outside_tol": int(sum(int((o > 1).sum()) for o in over)),
                "worst_over_tol": float(max(o.max() for o in over)),
                "max_abs_err_vs_plain": float(max((ky - py).abs().max(),
                                                  (ks - ps).abs().max())),
                "vs_float64": {"y": float((ky.double() - fy).abs().max()),
                               "state": float((ks.double() - fs).abs().max())},
                "state_equals_plain": bool(torch.equal(ks, ps))}
        rows.append(row)
        del ops_, py, ps, fy, fs
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "ssm_probe.json"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import ops, ssm_scan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True
    ).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], stdout=subprocess.PIPE, text=True).stdout.split()[0])
    libs, regs = build(ROOT / "build" / "ssm_probe")
    kinds = variants()
    calls = {name: scan_call(load_scan(libs[name]), kinds[name][0])
             for name in kinds}
    calls["library"] = ops.ssm_scan
    results = []

    def emit(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"phase": "rates", **rates(libs["rates"], props.multi_processor_count,
                                    mhz)})
    emit({"phase": "ptxas", "by_variant_and_g": regs})
    st, rd = ssm_scan.STATES_PER_LANE, ssm_scan.STEPS_PER_ROUND
    emit({"phase": "sass", **sass_counts(
        libs[f"states={st} round={rd}"], ssm_scan.scan_layout(FALCON[3]), st,
        rd)})
    for shape_name, shape in SHAPES.items():
        ops_ = operands(shape, args.seed)
        B, L, D, N = shape
        nbytes = 4 * (3 * B * L * D + 2 * B * L * N + D * N + B * D * N)
        names = [n for n in calls if shape_name == "falcon" or
                 n.startswith("states")]
        emit({"phase": "times", "shape_BLDN": list(shape), "cold_graph_ms": {
            n: chip_smoke.cold_graph_ms(calls[n], nbytes, *ops_)
            for n in names}})
        del ops_
        torch.cuda.empty_cache()
    emit({"phase": "accuracy", "tol": TOL,
          "rows": accuracy({n: calls[n] for n in calls
                            if not n.startswith("split")}, args.seed)})
    print(card, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "results": results},
                                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
