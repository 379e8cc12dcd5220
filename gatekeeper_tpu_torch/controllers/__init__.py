# Copied from gatekeeper_tpu/controllers/__init__.py for the PyTorch port.
