"""K8: the residency planner's page gather and page scatter (wrappers +
plain versions).

Replaces the JAX package's ``enforce/devpages.py``
``ResidencyPlanner.store`` and ``ResidencyPlanner.expand`` (item B8):
under a devpages budget a kind's ``[c_pad, r_pad]`` bool verdict mask
lives between sweeps as a slot buffer of ``n_slots`` pages of
``page_rows`` rows on the device, the other pages in a host mirror.
:func:`page_gather` splits a full mask into the slot buffer and one
staging buffer of the cold pages (copied to the host by the caller);
:func:`page_scatter` writes the slot buffer back into a full mask whose
other rows are zeros.
Page ``p``'s row ``j`` is row ``min(p * page_rows + j, r_pad - 1)``: the
ragged tail page repeats the last real row.  An empty slot (page -1)
gathers row 0 and scatters nothing.  The CUDA kernels are
``csrc/residency.cu``; its note gives the bound and the design.  Each
wrapper launches its kernel for CUDA tensors and uses its plain version
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from gatekeeper_tpu_torch.kernels import build

_GATHER_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 \
    + [ctypes.c_void_p]
_SCATTER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 \
    + [ctypes.c_void_p]


def _page_rows(pages: torch.Tensor, page_rows: int,
               n_rows: int) -> torch.Tensor:
    """int64 [len(pages) * page_rows]: each page's rows, clamped to the
    last row; an empty page (-1) reads row 0 throughout."""
    p = pages.to(torch.int64)[:, None]
    rows = p * page_rows + torch.arange(page_rows, dtype=torch.int64,
                                        device=pages.device)
    rows = torch.where(p < 0, 0, rows.clamp(max=n_rows - 1))
    return rows.reshape(-1)


def page_gather_plain(mask: torch.Tensor, slot_pages: torch.Tensor,
                      cold_pages: torch.Tensor, page_rows: int):
    """(slot_buf, staging): ``index_select`` of the slot pages' rows and
    of the cold pages' rows."""
    n_rows = mask.shape[1]
    return (mask.index_select(1, _page_rows(slot_pages, page_rows, n_rows)),
            mask.index_select(1, _page_rows(cold_pages, page_rows, n_rows)))


def page_scatter_plain(slot_buf: torch.Tensor, slot_pages: torch.Tensor,
                       n_rows: int, page_rows: int) -> torch.Tensor:
    """Zeros ``[c, n_rows]`` with the held slots' columns ``index_copy_``'d
    to their pages' rows (the tail page's repeats carry equal bits)."""
    out = torch.zeros((slot_buf.shape[0], n_rows), dtype=slot_buf.dtype,
                      device=slot_buf.device)
    held = torch.nonzero(slot_pages >= 0).reshape(-1)
    if held.numel():
        cols = (held[:, None] * page_rows + torch.arange(
            page_rows, device=held.device)).reshape(-1)
        out.index_copy_(1, _page_rows(slot_pages[held], page_rows, n_rows),
                        slot_buf.index_select(1, cols))
    return out


def _check(fn: str, t: torch.Tensor, name: str, dtype, ndim: int,
           device) -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{fn}: {name} must be {ndim}-d {dtype}, got "
                        f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def page_gather(mask: torch.Tensor, slot_pages: torch.Tensor,
                cold_pages: torch.Tensor, page_rows: int):
    """``(slot_buf bool [c, n_slots * page_rows], staging bool [c, n_cold
    * page_rows])`` of ``mask`` (bool [c, r]) through ``slot_pages``
    (int32 [n_slots], -1 = empty) and ``cold_pages`` (int32 [n_cold]).
    K8 on CUDA tensors, the plain version on CPU tensors."""
    if mask.device.type == "cpu":
        page_gather.plain_calls += 1
        return page_gather_plain(mask, slot_pages, cold_pages, page_rows)
    if mask.device.type != "cuda":
        raise ValueError(f"page_gather: unsupported device {mask.device}")
    _check("page_gather", mask, "mask", torch.bool, 2, mask.device)
    _check("page_gather", slot_pages, "slot_pages", torch.int32, 1,
           mask.device)
    _check("page_gather", cold_pages, "cold_pages", torch.int32, 1,
           mask.device)
    if page_rows < 1:
        raise ValueError(f"page_gather: page_rows {page_rows}")
    c_rows, n_rows = mask.shape
    n_slots, n_cold = slot_pages.shape[0], cold_pages.shape[0]
    # two allocations, not views of one: the planner keeps slot_buf
    # between sweeps and must not pin the staging bytes with it
    slot_buf = mask.new_empty((c_rows, n_slots * page_rows))
    staging = mask.new_empty((c_rows, n_cold * page_rows))
    fn = build.entry("residency", "gk_page_gather", _GATHER_ARGS)
    with build.on_device(mask.device):
        err = fn(mask.data_ptr(), slot_pages.data_ptr(),
                 cold_pages.data_ptr(), slot_buf.data_ptr(),
                 staging.data_ptr(), c_rows, n_rows, page_rows, n_slots,
                 n_cold, build.stream(mask.device))
    build.check(err, "page_gather launch")
    page_gather.launches += 1
    return slot_buf, staging


def page_scatter(slot_buf: torch.Tensor, slot_pages: torch.Tensor,
                 n_rows: int, page_rows: int) -> torch.Tensor:
    """Bool ``[c, n_rows]``: zeros with ``slot_buf`` (bool [c, n_slots *
    page_rows]) written back to the rows of the pages ``slot_pages``
    (int32 [n_slots], -1 = empty) holds.  K8 on CUDA tensors, the plain
    version on CPU tensors.  The kernel takes each real row of the tail
    page from its own place in the slot; the plain version writes row
    ``n_rows - 1`` once for each repeat, so the two agree where those
    repeats carry equal bits, as a gathered slot buffer does."""
    if slot_buf.device.type == "cpu":
        page_scatter.plain_calls += 1
        return page_scatter_plain(slot_buf, slot_pages, n_rows, page_rows)
    if slot_buf.device.type != "cuda":
        raise ValueError(f"page_scatter: unsupported device "
                         f"{slot_buf.device}")
    _check("page_scatter", slot_buf, "slot_buf", torch.bool, 2,
           slot_buf.device)
    _check("page_scatter", slot_pages, "slot_pages", torch.int32, 1,
           slot_buf.device)
    c_rows = slot_buf.shape[0]
    n_slots = slot_pages.shape[0]
    if page_rows < 1 or n_rows < 1 \
            or slot_buf.shape[1] != n_slots * page_rows:
        raise ValueError(f"page_scatter: slot_buf {tuple(slot_buf.shape)} "
                         f"for {n_slots} slots of {page_rows} rows into "
                         f"{n_rows} rows")
    # the kernel writes every byte, the rows of pages no slot holds as 0
    out = slot_buf.new_empty((c_rows, n_rows))
    fn = build.entry("residency", "gk_page_scatter", _SCATTER_ARGS)
    with build.on_device(slot_buf.device):
        err = fn(slot_buf.data_ptr(), slot_pages.data_ptr(), out.data_ptr(),
                 c_rows, n_rows, page_rows, n_slots,
                 build.stream(slot_buf.device))
    build.check(err, "page_scatter launch")
    page_scatter.launches += 1
    return out


page_gather.launches = 0
page_gather.plain_calls = 0
page_scatter.launches = 0
page_scatter.plain_calls = 0
