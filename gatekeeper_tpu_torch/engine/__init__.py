# Copied from gatekeeper_tpu/engine/__init__.py for the PyTorch port.
