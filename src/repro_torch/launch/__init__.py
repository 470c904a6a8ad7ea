"""Entry points (counterpart of ``repro.launch``): serving, and the
concrete input batches it and the tests use."""
