"""gatekeeper_tpu_torch — PyTorch / CUDA port of the gatekeeper_tpu package.

The audit path of the JAX package, rebuilt for one NVIDIA H100:

- host layers (``rego/``, ``ir/``, ``store/``, ``client/``, ``target/``,
  ``analysis/`` Stage-1 vet, ``library/``, ``native/``) are the port's
  own copies of the JAX package's modules, each naming its origin;
- ``engine/executor.py`` is the torch port of ``engine/veval.py`` and
  ``engine/torch_driver.py`` the audit path of ``engine/jax_driver.py``;
- ``kernels/`` holds the hand-written device kernels — K1, the IR
  evaluator as a generated Triton kernel per program; K2, count + top-k,
  and K3, the regex byte-DFA scan, in CUDA C++ under ``csrc/`` — each
  beside its plain PyTorch version.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
