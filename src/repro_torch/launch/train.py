"""Training launcher: TokenStore batches through the port's train step
and fault-tolerant loop on a mesh, on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --reduced --steps 4 --device cpu

The flags are the reference's (``python -m repro.launch.train``) and
``--device``.  ``--mesh host`` (the default, as in the reference) is the
(n, 1) mesh over the n ranks of the process group; ``single`` and
``multi`` are the production meshes, which need 256 or 512 ranks and
raise ``ValueError`` on fewer.  Without ``--coordinator`` (and no group
started by the caller) the group is one rank on an in-process store.
``--coordinator host:port`` starts the process group as the reference's
``jax.distributed.initialize`` starts its processes:
``torch.distributed.init_process_group`` over ``tcp://host:port`` with
``--num-hosts`` ranks, this one ``--host-id``; NCCL on the card, gloo on
the CPU.  A rank here is one card, where the reference's host holds
several devices (ROADMAP §3).  Each rank's TokenStore is seeded and
sliced by its coordinate along the data axes (``dp_rank`` / ``dp_size``),
and its batches are its rows of the global batch, so ranks that share a
data coordinate hold the same rows.  The launcher destroys the process
groups it started before it returns, and returns the final state gathered
into plain tensors.  Without ``--reduced`` the shape is the reference's
``train_4k`` (256 x 4,096 tokens a step), which no single card holds.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np


def token_batches(cfg, shape, dp_rank: int, dp_size: int, device):
    """The TokenStore's batches for the data coordinate ``dp_rank`` of
    ``dp_size`` (its samples drawn from the seed ``dp_rank``), as tensors on
    ``device``: up to 32 [B, S] batches of ``shape``."""
    import torch

    from repro_torch.core.opd import Predicate
    from repro_torch.pipeline.tokenstore import TokenStore, TokenStoreConfig

    store = TokenStore(TokenStoreConfig(), device=device)
    rng = np.random.default_rng(dp_rank)
    for i in range(1000):
        store.put_sample(i, rng.integers(0, cfg.vocab,
                                         shape.seq_len // 2).astype(np.int32),
                         b"web/high")
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
            for b in store.batches(Predicate("prefix", b"web/"),
                                   shape.global_batch, shape.seq_len,
                                   dp_rank=dp_rank, dp_size=dp_size,
                                   max_batches=32)]


def data_coordinate(mesh):
    """(this rank's index along the mesh's data axes, their size)."""
    from repro_torch.parallel.sharding import dp_axes, mesh_axes
    sizes = mesh_axes(mesh)
    rank, size = 0, 1
    for a in dp_axes(mesh):
        rank = rank * sizes[a] + mesh.get_local_rank(a)
        size *= sizes[a]
    return rank, size


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (the command line when None), train, print the
    ``[train]`` lines; returns the loop's ``LoopResult``, its state in
    plain tensors."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + shape")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--grad-compression", default=None, choices=[None, "bf16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import SHAPES, get_config, reduced_shape
    from repro_torch.core.lsm import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import P, mesh_axes
    from repro_torch.train import tree as T
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    device = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if args.coordinator:
            dist.init_process_group(
                backend, init_method=f"tcp://{args.coordinator}",
                world_size=args.num_hosts, rank=args.host_id)
        elif started:      # one rank on an in-process store
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        mesh = (make_host_mesh(device.type) if args.mesh == "host"
                else make_production_mesh(multi_pod=(args.mesh == "multi"),
                                          device_type=device.type))
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
        if args.reduced:
            cfg = cfg.reduced()
            shape = reduced_shape(shape)
        model = build_model(cfg)
        n_total, _ = cfg.param_count()
        print(f"[train] {cfg.name} ({n_total / 1e9:.2f}B params) "
              f"shape={shape.name} mesh={mesh_axes(mesh)} device={device}")

        # data: LSM-OPD token store with filtered selection; this rank's
        # rows of each global batch
        dp_rank, dp_size = data_coordinate(mesh)
        rows = sharding.named(mesh, P(sharding.dp_axes(mesh), None))
        from torch.distributed.tensor import DTensor
        batches = [{k: DTensor.from_local(v, mesh, rows, run_check=False)
                    for k, v in b.items()}
                   for b in token_batches(cfg, shape, dp_rank, dp_size,
                                          device)]

        ocfg = AdamWConfig(total_steps=args.steps)
        n_mb = args.microbatches or 1
        step = make_train_step(model, ocfg, mesh, num_microbatches=n_mb,
                               grad_compression=args.grad_compression)
        state = make_train_state(model, ocfg, 0, device=device)
        res = run(step, state, lambda s: batches[s % len(batches)],
                  LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                             ckpt_every=args.ckpt_every))
        res.state = T.map_tree(sharding.whole, res.state)
        print(f"[train] finished at step {int(res.state['step'])}; "
              f"loss {res.metrics_history[-1]['loss_total']:.4f}")
        return res
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
