# Copied from gatekeeper_tpu/store/__init__.py for the PyTorch port.
