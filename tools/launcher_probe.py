#!/usr/bin/env python3
"""Time the kernel wrappers whose C launchers look facts of the card up
once per card (pack, unpack, remap-pack, remap, the SSM scan forward and
backward), on one CUDA card, for this checkout or another one.

    python3 tools/launcher_probe.py [--src DIR] [--label NAME]

``repro_torch`` is imported from ``--src`` (default: this checkout's
``src``), so one run on a card can time two trees of the repository, an
older one unpacked beside this one, each building its kernels into its
own ``build/``.  Each wrapper is timed as ``chip_smoke.py`` times a
kernel row's ``ms`` (``chip_smoke.event_median_ms``, 10 calls back to
back, median of 21), at the shapes of PERF.md section 6's rows:

* ``pack_codes`` at width 16 on 120,384 codes (row 2a) and on 1,024
  codes, where the host's launch path is all there is to time;
* ``unpack_codes`` at widths 16 and 32 (rows 3a and 3b);
* ``remap_pack_codes`` and ``remap_codes`` on 1,198,372 entries, a table
  of 403,041 and 6 sources (rows 4 and 7);
* ``ssm_scan`` at falcon-mamba-7b's mixer, B 1, L 2,048, D 8,192, N 16
  (row 12), and at B 1, L 64, D 256, N 16, where the launch dominates;
* ``ssm_scan_bwd`` at hymba-1.5b's width, B 2, L 1,024, D 3,200, N 16 in
  float32 (row 13's shape, not its bf16 operands).

Every answer is checked against the wrapper's plain version on the card.
It prints one JSON line with the times, the card as ``nvidia-smi`` names
it and its power limit, and exits non-zero when no card is available or
an answer differs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("launcher_probe: no CUDA card available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from chip_smoke import event_median_ms
    from repro_torch.kernels import _build, bitpack, merge_remap, ssm_scan

    _build.library()                     # the build, outside every timing
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")

    def ints(lo, hi, n):
        return torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)

    def floats(*shape, scale=1.0, positive=False):
        x = rng.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(np.abs(x) if positive else x).to(dev)

    ok = {}
    out = {"probe": "launcher", "label": args.label, "src": str(args.src)}

    def row(name, fn, plain, tol=None):
        got, want = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(
            torch.equal(g, w) if tol is None
            else bool(torch.allclose(g, w, rtol=tol, atol=tol))
            for g, w in zip(got, want))
        ok[name] = same
        out[f"{name}_ms"] = event_median_ms(fn, inner=10)

    for n, tag in ((120_384, "pack_codes_w16"), (1_024, "pack_codes_w16_1k")):
        codes = ints(0, 1 << 16, n)
        row(tag, lambda c=codes: bitpack.pack_codes(c, 16),
            lambda c=codes: bitpack.pack_codes_plain(c, 16))
    for width, n in ((16, 120_384), (32, 1_198_372)):
        codes = ints(0, 1 << min(width, 31), n)
        words = bitpack.pack_codes_plain(codes, width)
        row(f"unpack_codes_w{width}",
            lambda w=words, b=width, m=n: bitpack.unpack_codes(w, b, m),
            lambda c=codes: c)

    n, t, n_src = 1_198_372, 403_041, 6
    offsets = torch.tensor(np.arange(n_src) * (t // n_src), dtype=torch.int32,
                           device=dev)
    evs, srcs = ints(-1, t // n_src, n), ints(0, n_src, n)
    table = ints(0, t, t)
    row("remap_pack_codes_w32",
        lambda: merge_remap.remap_pack_codes(evs, srcs, table, offsets, 32),
        lambda: merge_remap.remap_pack_codes_plain(evs, srcs, table, offsets,
                                                   32))
    row("remap_codes", lambda: merge_remap.remap_codes(evs, srcs, table,
                                                       offsets),
        lambda: merge_remap.remap_codes_plain(evs, srcs, table, offsets))

    for B, L, D, N, tag in ((1, 2048, 8192, 16, "ssm_scan_falcon"),
                            (1, 64, 256, 16, "ssm_scan_small")):
        ops = (floats(B, L, D), floats(B, L, D, scale=0.1, positive=True),
               -floats(D, N, positive=True), floats(B, L, N), floats(B, L, N))
        row(tag, lambda o=ops: ssm_scan.ssm_scan(*o),
            lambda o=ops: ssm_scan.ssm_scan_plain(*o), tol=1e-4)
    B, L, D, N = 2, 1024, 3200, 16
    ops = (floats(B, L, D), floats(B, L, D, scale=0.1, positive=True),
           -floats(D, N, positive=True), floats(B, L, N), floats(B, L, N),
           floats(B, L, D))
    # held against plain by the gpu tests at these widths; here only timed
    # beside a finite check (plain's autograd at this shape takes seconds)
    grads = ssm_scan.ssm_scan_bwd(*ops)
    ok["ssm_scan_bwd_finite"] = all(bool(torch.isfinite(g).all())
                                    for g in grads)
    out["ssm_scan_bwd_hymba_f32_ms"] = event_median_ms(
        lambda: ssm_scan.ssm_scan_bwd(*ops), inner=10)

    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out["answers_equal_plain"] = ok
    print(json.dumps(out), flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
