"""Carry state from the JAX package into the port, as plain data.

The port never imports the JAX package, so what crosses over is plain
Python and numpy: a lowered program as node tuples ``(op, args, meta)``
plus rule tuples ``(conjuncts, elem_axis)``, and a bindings dict of
numpy arrays.  The tests use this to feed the same program and the same
bindings to the reference evaluator and to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from gatekeeper_tpu_torch.ir.prep import Bindings
from gatekeeper_tpu_torch.ir.program import Node, Program, RuleSpec
from gatekeeper_tpu_torch.utils.device import resolve_device


def program_from_plain(nodes, rules) -> Program:
    """The port's Program from ``[(op, args, meta), ...]`` and
    ``[(conjuncts, elem_axis), ...]``."""
    return Program(
        nodes=tuple(Node(str(op), tuple(int(a) for a in args), tuple(meta))
                    for op, args, meta in nodes),
        rules=tuple(RuleSpec(tuple(int(c) for c in conj), axis)
                    for conj, axis in rules))


def program_to_plain(program: Program) -> tuple[list, list]:
    """Inverse of :func:`program_from_plain` for the port's Program."""
    return ([(n.op, n.args, n.meta) for n in program.nodes],
            [(r.conjuncts, r.elem_axis) for r in program.rules])


def arrays_to_device(arrays: dict[str, np.ndarray],
                     device: str | torch.device | None = None) \
        -> dict[str, torch.Tensor]:
    """Copy a bindings dict of numpy arrays onto ``device`` (CUDA by
    default), dtypes unchanged."""
    dev = resolve_device(device)
    return {nm: torch.from_numpy(np.ascontiguousarray(a)).to(dev, copy=True)
            for nm, a in arrays.items()}


def bindings_from_plain(arrays: dict[str, np.ndarray], n_constraints: int,
                        n_resources: int, c_pad: int, r_pad: int,
                        e_pads: dict[str, int] | None = None) -> Bindings:
    """The port's Bindings around a dict of numpy arrays."""
    return Bindings(arrays=dict(arrays), n_constraints=int(n_constraints),
                    n_resources=int(n_resources), c_pad=int(c_pad),
                    r_pad=int(r_pad), e_pads=dict(e_pads or {}))
