"""K3: regex byte-DFA verdicts per interned id (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py`` ``_dfa_device_table``
(item B2).  The CUDA kernel is ``csrc/dfa.cu``; its note gives the
bound and the design.  :func:`dfa_table` launches it for CUDA tensors
and uses :func:`dfa_table_plain` only for tensors on the CPU.
:func:`dfa_table_batched` is the same kernel over N clusters' stacked
tables (item B9, the fleet audit).
"""

from __future__ import annotations

import ctypes

import torch

from gatekeeper_tpu_torch.kernels import build

_SCAN_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]
_BATCHED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p]


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
    for name, t in (("ok", ok), ("xv", xv)):
        _check(t, torch.bool, 1, name)
        if t.shape[0] != n_ids:
            raise ValueError(f"{name} has {t.shape[0]} ids, strbytes {n_ids}")
    for t in (trans, accept, ok, xv):
        if t.device != strbytes.device:
            raise ValueError("dfa_table: inputs on different devices")
    if not 0 <= prefix <= width:
        raise ValueError(f"prefix {prefix} outside row width {width}")
    dev = strbytes.device
    out = torch.empty((n_ids,), dtype=torch.bool, device=dev)
    fn = build.entry("dfa", "gk_dfa_scan", _SCAN_ARGTYPES)
    with build.on_device(dev):
        err = fn(strbytes.data_ptr(), n_ids, width, prefix,
                 trans.data_ptr(), trans.element_size(), accept.data_ptr(),
                 ok.data_ptr(), xv.data_ptr(), out.data_ptr(),
                 build.stream(dev))
    build.check(err, "dfa_scan launch")
    dfa_table.launches += 1
    return out


dfa_table.launches = 0
dfa_table.plain_calls = 0


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
    dev = strbytes.device
    out = torch.empty((n_b, n_ids), dtype=torch.bool, device=dev)
    fn = build.entry("dfa", "gk_dfa_scan_batched", _BATCHED_ARGTYPES)
    with build.on_device(dev):
        err = fn(strbytes.data_ptr(), n_b, n_ids, width, prefix,
                 trans.data_ptr(), trans.shape[1], trans.element_size(),
                 accept.data_ptr(), ok.data_ptr(), xv.data_ptr(),
                 out.data_ptr(), build.stream(dev))
    build.check(err, "dfa_scan_batched launch")
    dfa_table_batched.launches += 1
    return out


dfa_table_batched.launches = 0
dfa_table_batched.plain_calls = 0


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
