"""Fault-tolerance runtime: straggler detection, failure injection,
checkpoint/restart supervision.  The port's own copy of the reference's
``repro/runtime/fault.py`` (plain Python, no tensors).

On a fleet the StepMonitor feeds the controller's slow-host eviction and
the supervisor reacts to hardware events; on one card the same code paths
are exercised via injected failures (tests assert that training resumes
from the latest checkpoint with the same results).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raise InjectedFailure on the given (1-based) global step calls."""
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


class StepMonitor:
    """EWMA step timer with straggler alarm (deviation factor)."""

    def __init__(self, alpha: float = 0.1, straggler_factor: float = 2.5,
                 warmup: int = 3):
        self.alpha = alpha
        self.factor = straggler_factor
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.stragglers: List[int] = []
        self.history: List[float] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.history.append(seconds)
        self.n += 1
        flagged = False
        if self.ewma is not None and self.n > self.warmup \
                and seconds > self.factor * self.ewma:
            self.stragglers.append(step)
            flagged = True
            # straggler steps do not poison the EWMA
            return flagged
        self.ewma = seconds if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * seconds
        return flagged

    @property
    def mean_step_s(self) -> float:
        return sum(self.history) / max(len(self.history), 1)


class Stopwatch:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
