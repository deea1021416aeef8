"""Tensor ops of the port: counterparts of picha_tpu/ops/ modules."""
