# Copied from gatekeeper_tpu/cmd/__init__.py for the PyTorch port.
