"""K3: regex byte-DFA verdicts per interned id (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py`` ``_dfa_device_table``
(item B2).  The CUDA kernel is ``csrc/dfa.cu``; its note gives the
bound and the design.  :func:`dfa_table` launches it for CUDA tensors
and uses :func:`dfa_table_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from gatekeeper_tpu_torch.kernels import build


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
    out = torch.empty((n_ids,), dtype=torch.bool, device=strbytes.device)
    lib = build.load("dfa")
    fn = lib.gk_dfa_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(strbytes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(strbytes.data_ptr(), n_ids, width, prefix,
                 trans.data_ptr(), trans.element_size(), accept.data_ptr(),
                 ok.data_ptr(), xv.data_ptr(), out.data_ptr(), stream)
    build.check(err, "dfa_scan launch")
    dfa_table.launches += 1
    return out


dfa_table.launches = 0
dfa_table.plain_calls = 0


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
