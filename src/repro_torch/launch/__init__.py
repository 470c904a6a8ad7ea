"""Entry points (counterpart of ``repro.launch``): serving, training, and
the concrete input batches they and the tests use."""
