"""Dynamics modules."""
