"""K4: dirty-row scatter into a device column (wrapper + plain version).

Replaces the JAX package's ``engine/veval.py``
``ProgramExecutor._scatter_rows`` (item B4), whose device half is the
functional update ``dev.at[rows].set(vals)`` along one axis.  The CUDA
kernel is ``csrc/scatter.cu``; its note gives the bound and the design.
:func:`scatter_rows` launches it for CUDA tensors and uses
:func:`scatter_rows_plain` only for tensors on the CPU.

Both return a new tensor and leave ``dev`` as it was, like the
reference: the old generation's device arrays may still back a stored
violation mask's signature.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gatekeeper_tpu_torch.kernels import build


def scatter_rows_plain(dev: torch.Tensor, rows: torch.Tensor,
                       vals: torch.Tensor, axis: int) -> torch.Tensor:
    """``dev`` with ``dev[..., rows[i], ...] = vals[..., i, ...]`` along
    ``axis``: ``index_copy_`` on a clone.  Duplicate rows carry equal
    values (bucket padding repeats the first row)."""
    return dev.clone().index_copy_(axis, rows.to(torch.int64), vals)


def scatter_rows(dev: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """New tensor: ``dev`` with the rows ``rows`` (int32 [b]) along
    ``axis`` replaced by ``vals`` (``dev``'s shape with ``b`` at
    ``axis``).  K4 on CUDA tensors, the plain version on CPU tensors."""
    if dev.device.type == "cpu":
        scatter_rows.plain_calls += 1
        return scatter_rows_plain(dev, rows, vals, axis)
    if dev.device.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {dev.device}")
    if vals.dtype != dev.dtype or dev.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"scatter_rows: dev {dev.dtype} and vals "
                        f"{vals.dtype} must share a dtype of 1, 2, 4 or 8 "
                        "bytes")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError("scatter_rows: rows must be a 1-d int32 tensor, got "
                        f"{rows.dim()}-d {rows.dtype}")
    if not 0 <= axis < dev.dim():
        raise ValueError(f"scatter_rows: axis {axis} of a {dev.dim()}-d "
                         "tensor")
    want = dev.shape[:axis] + (rows.shape[0],) + dev.shape[axis + 1:]
    if tuple(vals.shape) != tuple(want):
        raise ValueError(f"scatter_rows: vals {tuple(vals.shape)}, expected "
                         f"{tuple(want)}")
    for name, t in (("dev", dev), ("rows", rows), ("vals", vals)):
        if t.device != dev.device or not t.is_contiguous():
            raise ValueError(f"scatter_rows: {name} must be contiguous on "
                             f"{dev.device}")
    out = dev.clone()
    fn = build.load("scatter").gk_scatter_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    outer = math.prod(dev.shape[:axis])
    inner = math.prod(dev.shape[axis + 1:])
    with torch.cuda.device(dev.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(out.data_ptr(), vals.data_ptr(), rows.data_ptr(), outer,
                 dev.shape[axis], rows.shape[0], inner, dev.element_size(),
                 stream)
    build.check(err, "scatter_rows launch")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0
scatter_rows.plain_calls = 0
