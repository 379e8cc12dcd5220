# Copied from gatekeeper_tpu/api/__init__.py for the PyTorch port.
