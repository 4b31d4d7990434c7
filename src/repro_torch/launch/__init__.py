"""Command-line entry points of the port (``train``, ``serve``) and the
production layout: meshes, partition rules, shape stand-ins and the step
functions.

``repro_torch.launch.dryrun`` is not imported here: it owns its process's
default process group and runs as ``python -m repro_torch.launch.dryrun``.
Importing this package starts no process group and touches no device.
"""
from repro_torch.launch import mesh, sharding, specs, steps  # noqa: F401

__all__ = ["mesh", "sharding", "specs", "steps"]
