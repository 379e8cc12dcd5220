"""Hand-written device kernels of the port, each with its plain PyTorch
version: ``ir_eval`` (K1, Triton), ``topk`` (K2, CUDA) and ``dfa``
(K3, CUDA).  Triton and the CUDA libraries load inside the launching
functions, so these modules import on hosts without either."""
