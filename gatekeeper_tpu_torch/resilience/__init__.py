# Copied from gatekeeper_tpu/resilience/__init__.py for the PyTorch port.
"""Runtime resilience.  The port has the fault-injection harness
(``faults``) with the seams of the watch-class faults and
``queue_storm``; the snapshot tier and the backend supervisor are
ROADMAP A8."""
