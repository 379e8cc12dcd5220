# Copied from gatekeeper_tpu/ops/__init__.py for the PyTorch port.
"""Device/batch kernels: ops.regex_dfa (batched regex -> byte-DFA
matching, numpy + lax.scan twins) -- the high-cardinality answer for
regex-heavy templates (SURVEY section 7 hard-part 3)."""
