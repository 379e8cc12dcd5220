# Copied from gatekeeper_tpu/target/__init__.py for the PyTorch port.
