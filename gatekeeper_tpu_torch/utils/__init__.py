# Copied from gatekeeper_tpu/utils/__init__.py for the PyTorch port.
