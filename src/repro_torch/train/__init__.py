"""Optimizers over parameter trees (counterpart of ``repro.train``)."""
