"""Hand-written device kernels of the port, each with its plain PyTorch
version: ``ir_eval`` (K1 and K5, Triton), ``topk`` (K2, CUDA), ``dfa``
(K3, CUDA), ``scatter`` (K4, CUDA), ``devdelta`` (K6, CUDA) and
``invjoin`` (K7, CUDA).  Triton and the CUDA libraries load inside the
launching functions, so these modules import on hosts without either."""

from gatekeeper_tpu_torch.kernels.invjoin import (   # noqa: F401
    inv_join_mask, inv_join_mask_plain,
)
