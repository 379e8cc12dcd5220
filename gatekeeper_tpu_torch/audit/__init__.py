# Copied from gatekeeper_tpu/audit/__init__.py for the PyTorch port.
