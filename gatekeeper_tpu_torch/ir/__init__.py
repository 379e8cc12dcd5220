# Copied from gatekeeper_tpu/ir/__init__.py for the PyTorch port.
