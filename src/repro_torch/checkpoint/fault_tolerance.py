"""Fault tolerance: the straggler rule.

The port keeps only :func:`straggler_threshold` of
``repro.checkpoint.fault_tolerance`` for now: the serving engine's step
watchdog applies it to its own recent decode steps.  The training
supervisor and ``HeartbeatMonitor`` come with the training slice.
"""

from __future__ import annotations


def straggler_threshold(step_times, factor: float) -> float:
    """Slow-step cutoff: ``factor x median`` of the positive samples in
    ``step_times`` (0.0 when there are none — callers treat that as "no
    baseline yet, nothing is slow").  The serving engine's step watchdog
    applies it across its own recent decode steps
    (``EngineStats.slow_steps``)."""
    times = sorted(t for t in step_times if t > 0)
    if not times:
        return 0.0
    return factor * times[len(times) // 2]
