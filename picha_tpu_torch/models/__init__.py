"""Models of the port: counterparts of picha_tpu/models/ modules."""
