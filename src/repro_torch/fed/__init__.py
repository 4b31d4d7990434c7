"""Federated engine of the port (the rollout so far)."""
