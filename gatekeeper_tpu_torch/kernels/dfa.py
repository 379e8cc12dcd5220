"""K3: regex byte-DFA verdicts per interned id (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py`` ``_dfa_device_table``
(item B2).  The CUDA kernel is ``csrc/dfa.cu``; its note gives the
bound and the design.  :func:`dfa_table` launches it for CUDA tensors
and uses :func:`dfa_table_plain` only for tensors on the CPU.
:func:`dfa_table_batched` is the same kernel over N clusters' stacked
tables (item B9, the fleet audit).  :func:`plan` is the launch
geometry: where the table lives, the threads a block and the blocks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gatekeeper_tpu_torch.kernels import build

_SCAN_ARGTYPES = [ctypes.c_void_p] * 8
STAGE_THREADS = 512   # threads of a block that stages the table
MAX_IDS = 512         # ids a block (a tile) at most
SMEM_RESERVED = 1024  # shared memory the card keeps back for each block


class Limits(NamedTuple):
    """What the plan reads of a card: shared memory a block may opt in
    to, shared memory an SM holds, the SMs, and the threads an SM
    holds."""
    block_smem: int
    sm_smem: int
    sms: int
    sm_threads: int


class Plan(NamedTuple):
    """One launch of K3.  ``stored_width`` is the bytes an entry of the
    table takes in shared memory (1 to 256 states, 2 above), or 0 when
    the table's half is too large for a block and the kernel reads it
    from global memory; ``ids`` the ids a block takes at a time (a tile);
    ``blocks`` the blocks a table (grid.x; grid.y is the table);
    ``row_chunks`` the stride of a row copied to shared memory, in
    16-byte chunks (0: rows read from global memory); ``smem`` the
    shared memory a block takes."""
    stored_width: int
    threads: int
    ids: int
    blocks: int
    row_chunks: int
    smem: int

    @property
    def branch(self) -> str:
        return "shared" if self.stored_width else "ldg"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(n_batch: int, n_ids: int, width: int, states: int,
         limits: Limits) -> Plan:
    """The launch geometry of K3 on ``n_batch`` tables of ``states``
    states, ``n_ids`` ids of ``width`` bytes each.

    The table's columns 0-127 go to shared memory at the narrowest width
    that holds a state, with the accept flags after them, when that fits
    a block; else the kernel reads the table from global memory (chosen
    by ``states`` alone on a given card).  Rows of a multiple of 16 bytes
    go to shared memory at an odd stride of 16-byte chunks.  Ids a block: about what
    an SM gets when the ids of all tables spread over every SM, a
    multiple of 32 from 32 to ``MAX_IDS``, fewer where the rows and the
    table would not fit.  Threads: ``STAGE_THREADS`` where the table is
    staged (all of them stage it, the first ``ids`` then scan), else one
    an id.  Blocks a table: one a tile of ids, capped at the blocks the
    card holds at once over all tables (they loop over the rest)."""
    stored = 1 if states <= 256 else 2
    table = _round_up(128 * states * stored + states, 16)
    if table > limits.block_smem:
        stored, table = 0, 0
    ids = min(_round_up(-(-n_batch * n_ids // limits.sms), 32), MAX_IDS)
    chunks = (width // 16) | 1 if width and width % 16 == 0 else 0
    fit = ids
    while chunks and table + 16 * fit * chunks > limits.block_smem:
        if fit == 32:
            chunks = 0
        fit = max(32, fit // 2 // 32 * 32)
    if chunks:
        ids = fit
    threads = STAGE_THREADS if stored else ids
    smem = table + 16 * ids * chunks
    per_sm = max(1, min(limits.sm_threads // threads,
                        limits.sm_smem // (smem + SMEM_RESERVED)))
    tiles = -(-n_ids // ids)
    wave = max(1, limits.sms * per_sm // n_batch)
    return Plan(stored, threads, ids, max(1, min(tiles, wave)), chunks, smem)


def limits(dev: torch.device) -> Limits:
    """The card's :class:`Limits`."""
    p = torch.cuda.get_device_properties(dev)
    return Limits(p.shared_memory_per_block_optin,
                  p.shared_memory_per_multiprocessor,
                  p.multi_processor_count, p.max_threads_per_multi_processor)


def plan_for(trans: torch.Tensor, strbytes: torch.Tensor) -> Plan:
    """The :class:`Plan` a call of :func:`dfa_table` (``trans`` [S, 256])
    or :func:`dfa_table_batched` (``trans`` [N, S, 256]) on these CUDA
    inputs launches."""
    n_b = strbytes.shape[0] if strbytes.dim() == 3 else 1
    return plan(n_b, strbytes.shape[-2], strbytes.shape[-1],
                trans.shape[-2], limits(strbytes.device))


def dfa_table_plain(trans: torch.Tensor, accept: torch.Tensor,
                    strbytes: torch.Tensor, ok: torch.Tensor,
                    xv: torch.Tensor, prefix: int) -> torch.Tensor:
    """bool [U]: the reference scan in torch ops.  State 0 start, one
    gather per byte column after ``prefix`` (padding included), one
    TERM step ``trans[state, 0]``, then ``where(ok, accept[...], xv)``.
    Indices widen to int64 at the gather only."""
    flat = trans.reshape(-1)
    payload = strbytes[:, prefix:].to(torch.int64)
    state = torch.zeros((strbytes.shape[0],), dtype=torch.int64,
                        device=strbytes.device)
    for j in range(payload.shape[1]):
        state = flat[state * 256 + payload[:, j]].to(torch.int64)
    state = flat[state * 256].to(torch.int64)
    return torch.where(ok, accept[state], xv)


def dfa_table(trans: torch.Tensor, accept: torch.Tensor,
              strbytes: torch.Tensor, ok: torch.Tensor, xv: torch.Tensor,
              prefix: int) -> torch.Tensor:
    """bool [U] regex verdicts: K3 on CUDA tensors, the plain version on
    CPU tensors."""
    if strbytes.device.type == "cpu":
        dfa_table.plain_calls += 1
        return dfa_table_plain(trans, accept, strbytes, ok, xv, prefix)
    n_ids, width = strbytes.shape
    _check(strbytes, torch.uint8, 2, "strbytes")
    _check(trans, (torch.int32, torch.int16, torch.int8), 2, "trans")
    if trans.shape[1] != 256:
        raise ValueError(f"trans must be [S, 256], got {tuple(trans.shape)}")
    _check(accept, torch.bool, 1, "accept")
    if accept.shape[0] != trans.shape[0]:
        raise ValueError(f"accept has {accept.shape[0]} states, trans "
                         f"{trans.shape[0]}")
    for name, t in (("ok", ok), ("xv", xv)):
        _check(t, torch.bool, 1, name)
        if t.shape[0] != n_ids:
            raise ValueError(f"{name} has {t.shape[0]} ids, strbytes {n_ids}")
    for t in (trans, accept, ok, xv):
        if t.device != strbytes.device:
            raise ValueError("dfa_table: inputs on different devices")
    if not 0 <= prefix <= width:
        raise ValueError(f"prefix {prefix} outside row width {width}")
    out = torch.empty((n_ids,), dtype=torch.bool, device=strbytes.device)
    _launch(trans, accept, strbytes, ok, xv, prefix, 1, n_ids, width, out)
    dfa_table.launches += 1
    return out


dfa_table.launches = 0
dfa_table.plain_calls = 0


def load() -> None:
    """Build K3's library if it is missing, load it and bind its entry,
    ahead of the first launch (the driver's ingest warm calls it for a
    kind with a regex table)."""
    build.entry("dfa", "gk_dfa_scan", _SCAN_ARGTYPES)


def dfa_table_batched_plain(trans: torch.Tensor, accept: torch.Tensor,
                            strbytes: torch.Tensor, ok: torch.Tensor,
                            xv: torch.Tensor, prefix: int) -> torch.Tensor:
    """bool [N, T]: :func:`dfa_table_plain` per cluster on the stacked
    inputs' slice ``[i]``."""
    return torch.stack([dfa_table_plain(trans[i], accept[i], strbytes[i],
                                        ok[i], xv[i], prefix)
                        for i in range(strbytes.shape[0])])


def dfa_table_batched(trans: torch.Tensor, accept: torch.Tensor,
                      strbytes: torch.Tensor, ok: torch.Tensor,
                      xv: torch.Tensor, prefix: int) -> torch.Tensor:
    """bool [N, T] regex verdicts of N clusters (item B9, the fleet
    audit): ``trans`` [N, S, 256], ``accept`` [N, S], ``strbytes``
    [N, T, W], ``ok`` and ``xv`` [N, T], stacked along the cluster axis.
    On CUDA tensors one K3 launch covers all N * T ids, each reading
    its own cluster's table; on CPU tensors the plain scan runs per
    cluster."""
    if strbytes.device.type == "cpu":
        dfa_table_batched.plain_calls += 1
        return dfa_table_batched_plain(trans, accept, strbytes, ok, xv,
                                       prefix)
    _check(strbytes, torch.uint8, 3, "strbytes")
    n_b, n_ids, width = strbytes.shape
    _check(trans, (torch.int32, torch.int16, torch.int8), 3, "trans")
    if trans.shape[0] != n_b or trans.shape[2] != 256:
        raise ValueError(f"trans must be [{n_b}, S, 256], got "
                         f"{tuple(trans.shape)}")
    _check(accept, torch.bool, 2, "accept")
    if tuple(accept.shape) != tuple(trans.shape[:2]):
        raise ValueError(f"accept {tuple(accept.shape)} does not match "
                         f"trans {tuple(trans.shape)}")
    for name, t in (("ok", ok), ("xv", xv)):
        _check(t, torch.bool, 2, name)
        if tuple(t.shape) != (n_b, n_ids):
            raise ValueError(f"{name} is {tuple(t.shape)}, strbytes "
                             f"[{n_b}, {n_ids}, ...]")
    for t in (trans, accept, ok, xv):
        if t.device != strbytes.device:
            raise ValueError("dfa_table_batched: inputs on different "
                             "devices")
    if not 0 <= prefix <= width:
        raise ValueError(f"prefix {prefix} outside row width {width}")
    out = torch.empty((n_b, n_ids), dtype=torch.bool,
                      device=strbytes.device)
    _launch(trans, accept, strbytes, ok, xv, prefix, n_b, n_ids, width, out)
    dfa_table_batched.launches += 1
    return out


dfa_table_batched.launches = 0
dfa_table_batched.plain_calls = 0


_GEOMETRY: dict = {}   # call shape -> (int64 array for the C entry, address)


def geometry(dev: torch.device, n_b: int, n_ids: int, width: int,
             prefix: int, states: int, itemsize: int) -> ctypes.Array:
    """What ``gk_dfa_scan`` reads of a call, as its int64 array: the
    shapes and the :class:`Plan`, built once a call shape and device."""
    p = plan(n_b, n_ids, width, states, limits(dev))
    return (ctypes.c_int64 * 11)(n_b, n_ids, width, prefix, states,
                                 itemsize, p.stored_width, p.threads, p.ids,
                                 p.blocks, p.row_chunks)


def _launch(trans, accept, strbytes, ok, xv, prefix, n_b, n_ids, width,
            out) -> None:
    dev = strbytes.device
    key = (dev.index, n_b, n_ids, width, prefix, trans.shape[-2],
           trans.element_size())
    geo = _GEOMETRY.get(key)
    if geo is None:
        if key[5] < 1:
            raise ValueError("trans has no states")
        if len(_GEOMETRY) >= 1024:
            _GEOMETRY.clear()
        arr = geometry(dev, *key[1:])
        geo = _GEOMETRY[key] = (arr, ctypes.addressof(arr))
    fn = build.entry("dfa", "gk_dfa_scan", _SCAN_ARGTYPES)
    with build.on_device(dev), build.LAUNCH_LOCK:
        err = fn(geo[1], strbytes.data_ptr(), trans.data_ptr(),
                 accept.data_ptr(), ok.data_ptr(), xv.data_ptr(),
                 out.data_ptr(), build.stream(dev))
    build.check(err, "dfa_scan launch")


def _check(t: torch.Tensor, dtypes, ndim: int, name: str) -> None:
    if not isinstance(dtypes, tuple):
        dtypes = (dtypes,)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-d {dtypes}, got "
                        f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
