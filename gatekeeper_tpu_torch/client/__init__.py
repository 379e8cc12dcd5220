# Copied from gatekeeper_tpu/client/__init__.py for the PyTorch port.
