"""Fault injection and workload tooling shared by the recovery tests.

Port of ``repro/testing``.  It lives under ``src`` because the engine
itself is instrumented with ``crashpoint(...)`` site markers, and the
subprocess crash driver must be importable as
``python -m repro_torch.testing.crash_driver``.
"""

from repro_torch.testing.crashpoints import (
    CRASH,
    CRASH_POINTS,
    CrashPointRegistry,
    SimulatedCrash,
    crashpoint,
)

__all__ = [
    "CRASH",
    "CRASH_POINTS",
    "CrashPointRegistry",
    "SimulatedCrash",
    "crashpoint",
]
