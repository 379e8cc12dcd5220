# Copied from gatekeeper_tpu/utils/log.py for the PyTorch port.
"""Structured logging — the zap-through-logf analogue.

The reference logs structured key-value pairs everywhere via
controller-runtime's logf (zap backend, cmd/manager/main.go:38;
e.g. audit/manager.go:101 ``log.Info("constraint", "name", ...)``).
This is that surface on stdlib logging: named loggers emitting
``ts level logger msg k=v ...`` lines, with values rendered compactly
and errors carrying exception types.

Usage::

    from gatekeeper_tpu_torch.utils.log import logger
    log = logger("audit")
    log.info("sweep complete", violations=n, seconds=dt)
    log.error("status write failed", error=exc, constraint=name)

``GATEKEEPER_LOG_LEVEL`` (debug/info/warning/error, default info)
controls the threshold; handlers are installed once on the package
root logger and respect an embedding application's configuration (if
the root already has handlers, none are added)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Any

_ROOT = "gatekeeper_tpu"
_configured = False

# Optional callable returning ambient context kv (e.g. the active
# trace/span ids) merged into every log line.  obs/trace.py registers
# one at import; log stays importable without obs.
_context_provider = None


def set_context_provider(fn) -> None:
    """Register fn() -> dict | None whose pairs prefix every log
    line's kv (explicit kv wins on key collision)."""
    global _context_provider
    _context_provider = fn


def _render(v: Any) -> str:
    if isinstance(v, BaseException):
        return f"{type(v).__name__}({v})"
    if isinstance(v, str):
        return v if v and " " not in v and "=" not in v else repr(v)
    s = repr(v)
    return s if len(s) <= 120 else s[:117] + "..."


class _KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = (f"{self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
                f"{record.levelname:<5} {record.name} {record.getMessage()}")
        kv = getattr(record, "kv", None)
        if kv:
            base += " " + " ".join(f"{k}={_render(v)}"
                                   for k, v in kv.items())
        return base


class Logger:
    """Thin named wrapper adding key-value structure to stdlib calls."""

    def __init__(self, inner: logging.Logger):
        self._inner = inner

    def _log(self, level: int, msg: str, kv: dict) -> None:
        if self._inner.isEnabledFor(level):
            if _context_provider is not None:
                try:
                    ctx = _context_provider()
                except Exception:
                    ctx = None
                if ctx:
                    kv = {**ctx, **kv}
            self._inner.log(level, msg, extra={"kv": kv})

    def debug(self, msg: str, /, **kv: Any) -> None:
        self._log(logging.DEBUG, msg, kv)

    def info(self, msg: str, /, **kv: Any) -> None:
        self._log(logging.INFO, msg, kv)

    def warning(self, msg: str, /, **kv: Any) -> None:
        self._log(logging.WARNING, msg, kv)

    def error(self, msg: str, /, **kv: Any) -> None:
        self._log(logging.ERROR, msg, kv)


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(_ROOT)
    level = os.environ.get("GATEKEEPER_LOG_LEVEL", "info").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    # an embedding application that configured logging wins
    if root.handlers or logging.getLogger().handlers:
        return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(_KVFormatter())
    root.addHandler(h)
    root.propagate = False


def logger(name: str) -> Logger:
    """Named structured logger, e.g. logger("audit"), logger("webhook")."""
    _configure()
    return Logger(logging.getLogger(f"{_ROOT}.{name}"))
