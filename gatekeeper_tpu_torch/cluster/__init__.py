# Copied from gatekeeper_tpu/cluster/__init__.py for the PyTorch port.
