# Copied from gatekeeper_tpu/utils/compile_cache.py for the PyTorch port.
"""The audit warm-up (``warm_audit``) of the JAX package's compile-cache
module, alone.

The rest of that module is the XLA persistent compilation cache and its
hit/miss counters; the port's counterparts are the Triton and nvcc build
caches of ``kernels/build.py`` (ROADMAP A8 brings their accounting).

Unlike the reference's, the warm keeps its exception instead of
swallowing it: :class:`AuditWarm` holds it, and the audit manager's next
``audit_once`` raises it, as the driver's delta and ingest warms do.
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class AuditWarm:
    """One background audit warm-up: its thread, its seconds once it
    ended, and the exception it ended with (None when it succeeded or
    still runs)."""

    thread: threading.Thread | None = None
    seconds: float | None = None
    error: BaseException | None = None


def warm_audit(driver, target: str, cap: int = 20) -> AuditWarm:
    """Compile (and run once, on throwaway output) the capped-audit
    variants for every template kind currently registered, in the
    background.  (The reference's ``block`` flag has no caller.)

    The warm is one capped ``driver.query_audit``: on a TorchDriver its
    staging, uploads and launches run under the driver's ``_prep_lock``,
    as every sweep's and the ingest warm's do, so they never interleave
    with a sweep's."""
    warm = AuditWarm()

    def run():
        t0 = time.perf_counter()
        try:
            from gatekeeper_tpu_torch.client.interface import QueryOpts
            driver.query_audit(target, QueryOpts(limit_per_constraint=cap))
        except Exception as exc:    # raised by the next audit_once
            warm.error = exc
        finally:
            warm.seconds = time.perf_counter() - t0

    # route through the executor's background-thread registry so the
    # warm is joined before interpreter teardown (a compile in flight
    # at exit aborts the process)
    from gatekeeper_tpu_torch.engine.executor import spawn_bg
    warm.thread = spawn_bg(run, "audit-warmup")
    return warm
