# Copied from gatekeeper_tpu/library/__init__.py for the PyTorch port.
from gatekeeper_tpu_torch.library.templates import (  # noqa: F401
    LIBRARY, TARGET, all_docs, constraint_doc, template_doc)
from gatekeeper_tpu_torch.library.workload import make_mixed  # noqa: F401
