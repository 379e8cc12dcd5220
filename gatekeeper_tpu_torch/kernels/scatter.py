"""K4: dirty-row scatter into device columns (wrappers + plain versions).

Replaces the JAX package's ``engine/veval.py``
``ProgramExecutor._scatter_rows`` (item B4), whose device half is the
functional update ``dev.at[rows].set(vals)`` along one axis.  The CUDA
kernel is ``csrc/scatter.cu``; its note gives the bound and the design.
:func:`scatter_rows` updates one column, :func:`scatter_rows_many` every
column of a migration in one call (one kernel launch for up to
:data:`MAX_JOBS` columns of at most :data:`FUSED_ROWS` dirty rows).
Both launch K4 for CUDA tensors and use the plain versions only for
tensors on the CPU.

Both return new tensors and leave each ``dev`` as it was, like the
reference: the old generation's device arrays may still back a stored
violation mask's signature.  ``scatter_rows.launches`` counts every K4
launch, whichever entry made it; ``scatter_rows_many.launches`` counts
the batched entry's alone.
"""

from __future__ import annotations

import array
import ctypes
import math

import torch

from gatekeeper_tpu_torch.kernels import build

MAX_JOBS = 64
"""Jobs one launch takes (``kMaxJobs`` in ``csrc/scatter.cu``): their
descriptors travel in the kernel's 4 KB of parameters."""

FUSED_ROWS = 1024
"""Most rows a job of a one-launch batch scatters (``kScan`` in
``csrc/scatter.cu``); a batch with a longer job copies, then writes."""

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def scatter_rows_plain(dev: torch.Tensor, rows: torch.Tensor,
                       vals: torch.Tensor, axis: int) -> torch.Tensor:
    """``dev`` with ``dev[..., rows[i], ...] = vals[..., i, ...]`` along
    ``axis``: ``index_copy_`` on a clone.  Duplicate rows carry equal
    values (bucket padding repeats the first row)."""
    return dev.clone().index_copy_(axis, rows.to(torch.int64), vals)


def scatter_rows_many_plain(jobs) -> list[torch.Tensor]:
    """:func:`scatter_rows_plain` of each job ``(dev, rows, vals,
    axis)``."""
    return [scatter_rows_plain(*job) for job in jobs]


def _describe(dev: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              axis: int, what: str):
    """(new output tensor, the job's 8 descriptor words for
    ``gk_scatter_rows``), after checking the job."""
    size = dev.element_size()
    if vals.dtype != dev.dtype or size not in (1, 2, 4, 8):
        raise TypeError(f"{what}: dev {dev.dtype} and vals {vals.dtype} "
                        "must share a dtype of 1, 2, 4 or 8 bytes")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError(f"{what}: rows must be a 1-d int32 tensor, got "
                        f"{rows.dim()}-d {rows.dtype}")
    shape = dev.shape
    if not 0 <= axis < len(shape):
        raise ValueError(f"{what}: axis {axis} of a {len(shape)}-d tensor")
    if vals.shape != shape[:axis] + rows.shape + shape[axis + 1:]:
        raise ValueError(f"{what}: vals {tuple(vals.shape)}, expected "
                         f"{tuple(shape[:axis] + rows.shape)}"
                         f"{tuple(shape[axis + 1:])}")
    device = dev.device
    if rows.device != device or vals.device != device:
        raise ValueError(f"{what}: rows ({rows.device}) and vals "
                         f"({vals.device}) must be on {device}")
    if not (dev.is_contiguous() and rows.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError(f"{what}: dev, rows and vals must be contiguous")
    out = dev.new_empty(shape)
    return out, (out.data_ptr(), dev.data_ptr(), vals.data_ptr(),
                 rows.data_ptr(), math.prod(shape[:axis]), shape[axis],
                 rows.shape[0], math.prod(shape[axis + 1:]) * size)


def _launch(jobs, what: str) -> tuple[list[torch.Tensor], int]:
    """Launch K4 on every job (all on one CUDA device); returns the new
    columns and the number of kernel launches (one for every
    :data:`MAX_JOBS` jobs, two where one of them scatters more than
    :data:`FUSED_ROWS` rows)."""
    device = jobs[0][0].device
    outs = []
    desc = array.array("q")
    for dev, rows, vals, axis in jobs:
        if dev.device != device:
            raise ValueError(f"{what}: every column must be on {device}, "
                             f"got {dev.device}")
        out, words = _describe(dev, rows, vals, axis, what)
        outs.append(out)
        desc.extend(words)
    fn = build.entry("scatter", "gk_scatter_rows", _ARGTYPES)
    with build.on_device(device):
        n = fn(desc.buffer_info()[0], len(jobs), build.stream(device))
    if n < 0:
        build.check(-n, f"{what} launch")
    return outs, n


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
    (out,), n = _launch(((dev, rows, vals, axis),), "scatter_rows")
    scatter_rows.launches += n
    return out


def scatter_rows_many(jobs) -> list[torch.Tensor]:
    """:func:`scatter_rows` of each job ``(dev, rows, vals, axis)``, all
    columns on one device: K4 on CUDA tensors (one launch for every
    :data:`MAX_JOBS` jobs of at most :data:`FUSED_ROWS` rows), the plain
    version on CPU tensors."""
    jobs = list(jobs)
    if not jobs:
        return []
    device = jobs[0][0].device
    if device.type == "cpu":
        scatter_rows_many.plain_calls += 1
        return scatter_rows_many_plain(jobs)
    if device.type != "cuda":
        raise ValueError(f"scatter_rows_many: unsupported device {device}")
    outs, n = _launch(jobs, "scatter_rows_many")
    scatter_rows.launches += n
    scatter_rows_many.launches += n
    return outs


scatter_rows.launches = 0
scatter_rows.plain_calls = 0
scatter_rows_many.launches = 0
scatter_rows_many.plain_calls = 0
