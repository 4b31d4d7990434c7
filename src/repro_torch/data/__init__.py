"""Synthetic prompts and the Dirichlet client partition."""
