"""Utilities of the port (counterparts of `tfdiffeq_tpu/utils/`)."""
