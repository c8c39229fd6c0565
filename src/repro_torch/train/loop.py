"""Fault-tolerant training loop: periodic async checkpoints, straggler
monitoring, crash -> restore-and-continue supervision.  The port of
``repro/train/loop.py``.

The loop is deliberately dumb about *what* it runs (any step over
{params, opt, step}) and careful about *how*: every step is timed for the
straggler monitor (a host sync on the loss ends it, where the reference
blocks on it), and failures (injected here) trigger a restore of the
newest complete checkpoint onto the state's device and a replay of the
data stream from the restored step (the data iterator must be re-seekable
by step, which the TokenStore batches are via their deterministic
ordering).  With no checkpoint yet the loop restarts from ``init_state``,
which it never writes: the port's train step is functional, as the
reference's is (ROADMAP §3).  On a mesh every rank runs the loop: the
checkpoints gather the state and rank 0 writes them (``ckpt``), and a
restore loads the whole state onto each rank's card, which the train step
places on its mesh again (``make_train_step(mesh=...)`` places a plain
state by ``state_specs``), so a replay is bit for bit the failure-free
run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.parallel import sharding
from repro_torch.runtime.fault import (FailureInjector, InjectedFailure,
                                       StepMonitor)
from repro_torch.train import tree as T


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    async_ckpt: bool = True
    max_restarts: int = 5


@dataclasses.dataclass
class LoopResult:
    state: Any
    metrics_history: List[Dict[str, float]]
    restarts: int
    monitor: StepMonitor


def _step_of(state) -> int:
    return int(sharding.whole(state["step"]))


def run(
    train_step: Callable,
    init_state: Any,
    batch_fn: Callable[[int], Dict[str, Any]],
    cfg: LoopConfig,
    injector: Optional[FailureInjector] = None,
    log_every: int = 10,
    logger: Callable[[str], None] = print,
) -> LoopResult:
    monitor = StepMonitor()
    history: List[Dict[str, float]] = []
    restarts = 0
    ckpt_writer = ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_last) \
        if cfg.async_ckpt else None
    device = T.leaves(init_state)[0].device

    state = init_state
    # resume if a checkpoint exists (cold restart path)
    last = ckpt.latest_step(cfg.ckpt_dir)
    if last is not None:
        _, state = ckpt.restore(cfg.ckpt_dir, init_state, device=device)
        logger(f"[loop] resumed from step {last}")

    step = _step_of(state)
    while step < cfg.total_steps:
        try:
            batch = batch_fn(step)
            t0 = time.perf_counter()
            if injector is not None:
                injector.check(step + 1)
            state, metrics = train_step(state, batch)
            metrics["loss_total"].item()
            dt = time.perf_counter() - t0
            step += 1
            flagged = monitor.record(step, dt)
            m = {k: float(v) for k, v in metrics.items()}
            m["step_seconds"] = dt
            history.append(m)
            if flagged:
                logger(f"[loop] straggler step {step}: {dt:.3f}s "
                       f"(ewma {monitor.ewma:.3f}s)")
            if step % log_every == 0:
                logger(f"[loop] step {step} loss={m.get('loss', m['loss_total']):.4f} "
                       f"({dt * 1e3:.0f} ms)")
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                if ckpt_writer is not None:
                    ckpt_writer.submit(step, state)
                else:
                    ckpt.save(cfg.ckpt_dir, step, state, keep_last=cfg.keep_last)
        except InjectedFailure as e:
            restarts += 1
            logger(f"[loop] {e}; restarts={restarts}")
            if restarts > cfg.max_restarts:
                raise
            if ckpt_writer is not None:
                ckpt_writer.wait()
            last = ckpt.latest_step(cfg.ckpt_dir)
            if last is None:
                logger("[loop] no checkpoint yet; restarting from init")
                state = init_state
                step = 0
            else:
                _, state = ckpt.restore(cfg.ckpt_dir, init_state,
                                        device=device)
                step = _step_of(state)
                logger(f"[loop] restored step {step}")
    if ckpt_writer is not None:
        ckpt_writer.wait()
        ckpt_writer.close()
    return LoopResult(state, history, restarts, monitor)
