# Copied from gatekeeper_tpu/watch/__init__.py for the PyTorch port.
