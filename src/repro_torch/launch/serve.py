"""Serving launcher: batched greedy decoding with the port's decode step,
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --requests 8 --device cpu

The flags are the reference's (``python -m repro.launch.serve``) and
``--device``; the parameters are the port's own ``init(0)``, so the tokens
differ from the reference launcher's, which draws its own.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, List[int]]:
    """Parse ``argv`` (the command line when None), serve, print the
    ``[serve]`` line; returns the tokens by request id."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           max_seq=args.max_seq, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab, 8).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    print(f"[serve] {cfg.name}: {len(results)} requests, {toks} tokens, "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s)")
    return results


if __name__ == "__main__":
    main()
