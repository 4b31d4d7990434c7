"""Round-summary records (counterpart of part of ``repro.obs``)."""
