"""Subprocess side of the kill-based crash tests.

Port of ``repro/testing/crash_driver.py``.  The recovery tests mostly
simulate crashes in-process (``SimulatedCrash`` and
``WALWriter.simulate_power_loss``), which is fast enough to enumerate the
crash points.  This driver is the ground-truth variant: it runs the same
deterministic workload in a child process with the armed site set to
``action='exit'``, so the crash is an honest ``os._exit(137)``: no Python
unwinding, no buffered file flushing, no atexit.  The parent then restores
whatever the dead process left in the spill directory.

    python -m repro_torch.testing.crash_driver --spill DIR \\
        --point flush.before_manifest [--maintenance background] \\
        [--device cpu]

The tree runs on ``--device`` (the card by default), with its flushes and
compactions inline (``--maintenance sync``, the default) or on the
maintenance workers (``background``: a site on a worker kills the process
from that thread).  Acknowledgement
protocol: every ``--ack-every`` acknowledged mutations the driver
atomically rewrites ``ACKS.json`` in the spill directory with

    {"acked_muts": <ops that fully returned>,
     "durable_seqno": <WAL fsync watermark at that instant>}

through tmp + fsync + rename, so the parent gets a crash-safe lower bound
on what recovery must reproduce.  Exit codes: 137 = the armed site fired,
0 = the workload completed without reaching it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _write_acks(spill_dir: str, acked_muts: int, durable_seqno: int) -> None:
    path = os.path.join(spill_dir, "ACKS.json")
    fd, tmp = tempfile.mkstemp(dir=spill_dir, prefix=".acks-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"acked_muts": acked_muts,
                       "durable_seqno": durable_seqno}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spill", required=True)
    ap.add_argument("--codec", default="opd")
    ap.add_argument("--backend", default="numpy")
    ap.add_argument("--maintenance", default="sync",
                    choices=["sync", "background"])
    ap.add_argument("--wal", default="every", choices=["group", "every"])
    ap.add_argument("--point", required=True)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--key-space", type=int, default=400)
    ap.add_argument("--ack-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.lsm import LSMConfig, LSMTree
    from repro_torch.testing.crashpoints import CRASH
    from repro_torch.testing.workload import apply_op, gen_ops

    cfg = LSMConfig(codec=args.codec, filter_backend=args.backend,
                    compaction_backend=args.backend,
                    maintenance=args.maintenance, wal_sync=args.wal,
                    memtable_bytes=8 * 1024, file_bytes=16 * 1024,
                    l0_limit=2, size_ratio=3, max_levels=5,
                    blob_gc_threshold=0.3)
    tree = LSMTree(cfg, spill_dir=args.spill, device=args.device)
    ops = gen_ops(args.seed, args.n, args.key_space)

    _write_acks(args.spill, 0, 0)
    CRASH.arm(args.point, skip=args.skip, action="exit")

    acked = 0
    for op in ops:
        apply_op(tree, op)
        acked += op[0] in ("put", "delete")
        if acked % args.ack_every == 0:
            _write_acks(args.spill, acked, tree.wal.durable_seqno)
    # the end without the site firing: the parent skips rather than
    # report a vacuous pass
    CRASH.disarm()
    _write_acks(args.spill, acked, tree.wal.durable_seqno)
    tree.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
