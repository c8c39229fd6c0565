"""Training launcher: TokenStore batches through the port's train step
and fault-tolerant loop, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --reduced --steps 4 --device cpu

The flags are the reference's (``python -m repro.launch.train``) and
``--device``; ``--host-id`` / ``--num-hosts`` are the TokenStore's
``dp_rank`` / ``dp_size`` and its seed.  The mesh's spec arithmetic is
ported (``parallel/sharding.py``, ``launch/mesh.py``, ``state_specs``);
the reference's ``--mesh`` and ``--coordinator``
(``jax.distributed.initialize``) wait for ROADMAP §1 item 5(g)(ii), with
``ShardCtx`` (the model's ``ctx``), ``moe_impl='ep'`` and
``remat_policy='dots'``.  The TokenStore's selection scans run
``fused_zone_filter`` on the card.  Without ``--reduced`` the shape is the
reference's ``train_4k`` (256 x 4,096 tokens a step), which no single card
holds.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (the command line when None), train, print the
    ``[train]`` lines; returns the loop's ``LoopResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + shape")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--grad-compression", default=None, choices=[None, "bf16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import SHAPES, get_config, reduced_shape
    from repro_torch.core.lsm import resolve_device
    from repro_torch.core.opd import Predicate
    from repro_torch.models.registry import build_model
    from repro_torch.pipeline.tokenstore import TokenStore, TokenStoreConfig
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = reduced_shape(shape)
    model = build_model(cfg)
    n_total, _ = cfg.param_count()
    print(f"[train] {cfg.name} ({n_total / 1e9:.2f}B params) "
          f"shape={shape.name} device={device}")

    # data: LSM-OPD token store with filtered selection
    store = TokenStore(TokenStoreConfig(), device=device)
    rng = np.random.default_rng(args.host_id)
    for i in range(1000):
        store.put_sample(i, rng.integers(0, cfg.vocab,
                                         shape.seq_len // 2).astype(np.int32),
                         b"web/high")
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in store.batches(Predicate("prefix", b"web/"),
                                      shape.global_batch, shape.seq_len,
                                      dp_rank=args.host_id,
                                      dp_size=args.num_hosts,
                                      max_batches=32)]

    ocfg = AdamWConfig(total_steps=args.steps)
    n_mb = args.microbatches or 1
    step = make_train_step(model, ocfg, num_microbatches=n_mb,
                           grad_compression=args.grad_compression)
    state = make_train_state(model, ocfg, 0, device=device)
    res = run(step, state, lambda s: batches[s % len(batches)],
              LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                         ckpt_every=args.ckpt_every))
    print(f"[train] finished at step {int(res.state['step'])}; "
          f"loss {res.metrics_history[-1]['loss_total']:.4f}")
    return res


if __name__ == "__main__":
    main()
