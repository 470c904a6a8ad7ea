"""IVF routing over PDX buckets (counterpart of ``repro.index``)."""
