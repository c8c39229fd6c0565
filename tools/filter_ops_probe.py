#!/usr/bin/env python3
"""Cold time of the single-range filters' ``ops`` entry points on one CUDA
card, for this checkout or another one.

    python3 tools/filter_ops_probe.py [--src DIR] [--label NAME] [--n N]

``repro_torch`` is imported from ``--src`` (default: this checkout's
``src``), so one run on a card can time two trees of the repository, an
older one unpacked beside this one, with the same code; each builds its
kernels into its own ``build/``.  On ``--n`` entries (default 1,198,372:
the largest SCT of ``chip_smoke.py``'s main tree, as its fig5 phase hands
it over, not a whole number of 32,768-entry tiles) it times, in CUDA
graphs with a fresh copy of the operands every call
(``chip_smoke.cold_graph_ms``):

* ``ops.range_filter_packed`` on random words of width 32 and one range;
* ``ops.range_filter_codes`` on random codes in [-1, 403,041) and one
  range;
* beside them the same traffic as one copy: ``words.clone()`` (8 bytes a
  word) and ``codes.to(torch.int8)`` (5 bytes a code).

Both answers are checked against numpy.  It prints one JSON line with the
times, the card as ``nvidia-smi`` names it and its power limit, and exits
non-zero when no card is available.
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
    ap.add_argument("--n", type=int, default=1_198_372)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("filter_ops_probe: no CUDA card available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from chip_smoke import cold_graph_ms
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed)
    n = args.n
    w_np = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    c_np = rng.integers(-1, 403_041, n).astype(np.int32)
    words = torch.from_numpy(w_np.view(np.int32)).cuda()
    codes = torch.from_numpy(c_np).cuda()
    w_lo, w_hi = 0x40000000, 0x4FFFFFFF
    c_lo, c_hi = 1_000, 26_000

    def packed(w):
        return ops.range_filter_packed(w, 32, w_lo, w_hi)

    def code_mask(c):
        return ops.range_filter_codes(c, c_lo, c_hi)

    ok_packed = np.array_equal(packed(words).cpu().numpy().view(np.uint32),
                               ((w_np >= w_lo) & (w_np <= w_hi))
                               .astype(np.uint32))
    ok_codes = np.array_equal(code_mask(codes).cpu().numpy(),
                              (c_np >= c_lo) & (c_np <= c_hi))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"probe": "filter_ops", "label": args.label,
           "src": str(args.src), "n": n, "card": card,
           "range_filter_packed_ops_cold_graph_ms":
               cold_graph_ms(packed, 8 * n, words),
           "words_clone_cold_graph_ms": cold_graph_ms(torch.clone, 8 * n,
                                                      words),
           "range_filter_codes_ops_cold_graph_ms":
               cold_graph_ms(code_mask, 5 * n, codes),
           "codes_to_int8_cold_graph_ms": cold_graph_ms(
               lambda c: c.to(torch.int8), 5 * n, codes),
           "answers_equal_numpy": ok_packed and ok_codes}
    print(json.dumps(out), flush=True)
    return 0 if ok_packed and ok_codes else 1


if __name__ == "__main__":
    sys.exit(main())
