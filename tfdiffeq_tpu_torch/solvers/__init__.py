"""Problem canonicalization and the adaptive RK engine."""
