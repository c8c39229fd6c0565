#!/usr/bin/env python3
"""Host seconds of the port's write and scan path, for this checkout or
another one, with no kernel launched.

    python3 tools/host_path_probe.py [--src DIR] [--label NAME] [--n N]

``repro_torch`` is imported from ``--src`` (default: this checkout's
``src``), so runs of two trees on one machine, interleaved (A B B A),
tell a change of the host code from a change of the machine.  One
``LSMTree`` on ``device='cpu'`` in ``chip_smoke.main_config()`` (16-byte
keys, 256-byte values, 32 MiB files, size ratio 10, ``l0_limit`` 4)
takes ``--n`` puts (default 2^19) from ``chip_smoke.make_stream`` in
batches of 2^16, then ``compact()`` and one ``filter_many`` over the
smoke's 16 predicates; the kernels' plain versions run on the CPU tensors.
It prints one JSON line with the seconds of each step, the flushes and
compactions, and, where ``nvidia-smi`` answers, the card's name and power
limit of the machine it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.TimeoutExpired):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--n", type=int, default=1 << 19)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    from chip_smoke import main_config, make_preds, make_stream
    from repro_torch import LSMTree, Predicate

    keys, vocab, vidx, _ = make_stream(np.random.default_rng(args.seed),
                                       args.n, 256)
    cfg = main_config()
    batch = 1 << 16
    t0 = time.perf_counter()
    tree = LSMTree(cfg, device="cpu")
    for i in range(0, args.n, batch):
        tree.put_batch(keys[i:i + batch], vocab[vidx[i:i + batch]])
    t1 = time.perf_counter()
    tree.compact()
    t2 = time.perf_counter()
    res = tree.filter_many([Predicate(*p) for p in make_preds(vocab)])
    t3 = time.perf_counter()
    print(json.dumps({
        "probe": "host_path", "label": args.label, "src": str(args.src),
        "n": args.n, "ingest_s": t1 - t0, "compact_s": t2 - t1,
        "filter_many_s": t3 - t2, "total_s": t3 - t0,
        "n_flushes": tree.n_flushes, "n_compactions": tree.n_compactions,
        "rows_matched": sum(int(r.keys.shape[0]) for r in res),
        "cpu_count": os.cpu_count(), "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
