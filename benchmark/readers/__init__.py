"""Readers of the benchmark's metrics, one module each: ``read(ctx, spec)``
returns the metric's number from the run's context (host-clock spans,
program counters, the device trace) or None where the run has nothing to
read for it. ``spec`` is the metric's file under ``metrics/``."""
