"""FIRM's in-client resolution: MGDA solvers and ``resolve`` (counterpart
of ``repro.core``)."""
