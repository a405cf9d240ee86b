"""Trajectory evaluation (the port's copy of the JAX package's ``eval``)."""
