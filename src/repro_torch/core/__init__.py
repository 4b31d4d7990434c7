"""FIRM's in-client resolution (MGDA solvers and ``resolve``), FedAvg, the
drift diagnostics and the comms ledger (counterpart of ``repro.core``)."""
