"""Dynamics modules."""

from .cnf import CNFDynamics, augmented_dynamics, log_prob, sample

__all__ = ["CNFDynamics", "augmented_dynamics", "log_prob", "sample"]
