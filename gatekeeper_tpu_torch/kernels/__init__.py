"""Hand-written device kernels of the port, each with its plain PyTorch
version: ``ir_eval`` (K1 and K5, Triton), ``topk`` (K2, CUDA), ``dfa``
(K3, CUDA), ``scatter`` (K4, CUDA), ``devdelta`` (K6, CUDA),
``invjoin`` (K7, CUDA) and ``residency`` (K8, CUDA).  Triton and the
CUDA libraries load inside the launching functions, so these modules
import on hosts without either."""

from gatekeeper_tpu_torch.kernels.invjoin import (   # noqa: F401
    inv_join_mask, inv_join_mask_plain,
)
from gatekeeper_tpu_torch.kernels.residency import (   # noqa: F401
    page_gather, page_gather_plain, page_scatter, page_scatter_plain,
)
