"""Error taxonomy of the port (counterpart of `picha_tpu/errors.py`): the
classes the port raises, with the reference's names, so callers catch
the same failures from either package."""


class PichaError(Exception):
    """Base class of the port's errors."""


class InvalidImageError(PichaError):
    """The image is malformed (bad dimensions, a degenerate resize
    window)."""


class InvalidOptionsError(PichaError):
    """An option is out of range or unknown (bad filter, filter width)."""


class UnsupportedFormatError(PichaError):
    """No codec recognises the supplied bytes."""


class CodecError(PichaError):
    """A codec failed on a bitstream (e.g. fractional chroma sampling)."""
