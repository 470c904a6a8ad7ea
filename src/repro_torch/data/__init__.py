"""Data (counterpart of ``repro.data``): synthetic collections and the
training token stream, copies of the reference's NumPy-only modules."""
