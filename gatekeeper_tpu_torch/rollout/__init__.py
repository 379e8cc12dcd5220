# Copied from gatekeeper_tpu/rollout/__init__.py for the PyTorch port.
"""Policy rollout: the durable admission capture log.

``capture`` is the segmented, CRC-framed capture log with a bounded
queue and a background writer: the flight recorder's admission corpus
store (obs/flightrecorder.py).  The reference's promotion controller
(``rollout/controller.py``) and fleet graduation (``rollout/fleet.py``)
come with the port's what-if and rollout slice (ROADMAP A7).  Nothing
here imports torch, so the admission path pays no import for it.
"""
