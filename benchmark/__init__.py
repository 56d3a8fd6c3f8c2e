"""The benchmark of beam_slam_tpu_torch on the card: a data-driven harness
(``run.py``, ``harness.py``), the traffic generators, the plain references
and the metrics' readers."""
