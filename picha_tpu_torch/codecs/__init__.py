"""Host codecs of the port (counterpart of picha_tpu/codecs/ and the
JPEG entry points of picha_tpu/native)."""
