# Copied from gatekeeper_tpu/client/interface.py for the PyTorch port.
"""The Driver seam — where evaluation engines plug in.

The reference's Driver interface is six methods over Rego sources and
path-addressed JSON (vendor/.../drivers/interface.go:21-33).  The native
equivalent is typed rather than stringly:

  reference                      this seam
  ---------------------------------------------------------------
  Init                           init(targets)
  PutModule(name, rego)          put_template(target, kind, compiled)
  DeleteModule(name)             delete_template(target, kind)
  PutData("/constraints/...")    put_constraint(target, kind, name, c)
  PutData("/external/...")       put_data(target, key, meta, obj)
  DeleteData(path)               delete_constraint / delete_data / wipe_data
  Query("hooks[t].violation")    query_review(target, review, opts)
  Query("hooks[t].audit")        query_audit(target, opts)
  Dump                           dump()

Two drivers implement it: ``local`` (scalar oracle engine, the dev /
conformance reference — analogue of drivers/local) and ``jax`` (vectorized
device engine with scalar fallback).  Both must pass the same conformance
suite, like the reference's local and remote drivers
(client_test.go:17-23).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

from gatekeeper_tpu_torch.api.templates import CompiledTemplate
from gatekeeper_tpu_torch.client.targets import TargetHandler
from gatekeeper_tpu_torch.client.types import Result
from gatekeeper_tpu_torch.store.table import ResourceMeta


@dataclasses.dataclass
class QueryOpts:
    tracing: bool = False  # drivers.Tracing (interface.go:9-19)
    # audit: stop formatting results after N per constraint (the audit
    # manager's -constraintViolationsLimit, reference manager.go:35; the
    # jax driver then only host-formats up to N violating pairs per
    # constraint while still counting the rest on device)
    limit_per_constraint: int | None = None
    # audit: force a FULL sweep — the jax driver drops its mask /
    # bindings / format memoization for this sweep so every
    # constraint×resource pair is genuinely re-prepared, re-uploaded and
    # re-evaluated ("full sweep" vs "memoized steady" are two separately
    # metered numbers; the scalar oracle is always full, so it ignores
    # this flag)
    full: bool = False
    # overload brownout (webhook/overload.py): enforcement actions to
    # SKIP entirely this query — e.g. frozenset({"dryrun"}) or
    # frozenset({"dryrun", "warn"}).  Constraints with a shed action are
    # filtered out before any evaluation (scalar or device); "deny" is
    # never a legal member — deny constraints are never shed, only the
    # failurePolicy path may reject them wholesale.
    shed_actions: frozenset[str] | None = None


class Driver(abc.ABC):
    @abc.abstractmethod
    def init(self, targets: dict[str, TargetHandler]) -> None: ...

    @abc.abstractmethod
    def put_template(self, target: str, kind: str, compiled: CompiledTemplate) -> None: ...

    @abc.abstractmethod
    def delete_template(self, target: str, kind: str) -> None: ...

    @abc.abstractmethod
    def put_constraint(self, target: str, kind: str, name: str, constraint: dict) -> None: ...

    @abc.abstractmethod
    def delete_constraint(self, target: str, kind: str, name: str) -> None: ...

    @abc.abstractmethod
    def put_data(self, target: str, key: str, meta: ResourceMeta, obj: dict) -> None: ...

    def put_data_batch(self, target: str,
                       entries: list[tuple[str, ResourceMeta, dict]]) -> None:
        """Bulk ingest; drivers override to take their write lock once
        (LocalDriver) or ship one wire call (RemoteDriver) — this
        default only guarantees the semantics."""
        for key, meta, obj in entries:
            self.put_data(target, key, meta, obj)

    @abc.abstractmethod
    def delete_data(self, target: str, key: str) -> bool: ...

    @abc.abstractmethod
    def wipe_data(self, target: str) -> None: ...

    @abc.abstractmethod
    def query_review(self, target: str, review: dict,
                     opts: QueryOpts | None = None) -> tuple[list[Result], str | None]: ...

    def query_review_batch(self, target: str, reviews: list[dict],
                           opts: QueryOpts | None = None) -> list[tuple]:
        """Batch admission; drivers override to evaluate as one pass
        (JaxDriver's [C, B] device path, RemoteDriver's single wire
        call).  The default is the per-review loop, so every call site
        may invoke this unconditionally."""
        return [self.query_review(target, rv, opts) for rv in reviews]

    @abc.abstractmethod
    def query_audit(self, target: str,
                    opts: QueryOpts | None = None) -> tuple[list[Result], str | None]: ...

    @abc.abstractmethod
    def dump(self) -> dict: ...
