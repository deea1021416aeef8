"""TIFF sample transforms, decompressed strip rows -> top-left rgba:
kernel K16.

Counterpart of `picha_tpu/pipeline/tiff_batch.py::_jit_transform`
(:139-238), per signature `(width, height, spp, bits, photometric,
predictor, orientation, endian, has_extras)`: 16-bit samples with the
file's byte order folded, 8-bit, or 1/2/4-bit unpacked MSB-first; the
predictor 2 undo (`cumsum % 2^bits` along the row, 8 and 16 bits only:
sub-byte raises CodecError as the reference does); to 8 bits (`>> 8`, or
`(x * 255) // maxv`); grey (inverted for WhiteIsZero), rgb, the colormap
take, the CMYK fold `(255 - c)(255 - k) // 255`, YCbCr in 16.16 fixed
point on the raw samples (int32, wrapping, as the reference's graph) with
an arithmetic `>> 16` and a clip to 0-255; alpha from the extra samples,
or 255; orientations 1-8, 5-8 transposed.

  `tiff_transform_plain`  the torch version
  `tiff_transform`        K16 (`csrc/tiff_transform.cu`) for CUDA
                          tensors, the plain version for CPU tensors
  `kernel_info`           the build of the K16 kernel a signature launches
"""
from __future__ import annotations

import torch

from ..errors import CodecError
from ..kernels._build import KERNELS, ptr, require_cuda, stream_of

PHOTOMETRICS = (0, 1, 2, 3, 5, 6)


def out_shape(n: int, sig) -> tuple:
    """The (N, H', W', 4) rgba shape of a batch of signature `sig`."""
    width, height, orientation = sig[0], sig[1], sig[6]
    return (n, width, height, 4) if orientation >= 5 else \
        (n, height, width, 4)


def _validate(rows, sig):
    (width, height, spp, bits, photometric, predictor, orientation,
     endian, _extras) = sig
    if rows.dim() != 3 or rows.dtype != torch.uint8 or \
            rows.shape[1] != height or \
            rows.shape[2] * 8 < width * spp * bits:
        raise ValueError(f"tiff_transform expects (N, {height}, rowbytes) "
                         f"uint8 rows")
    if predictor == 2 and bits not in (8, 16):
        raise CodecError("predictor unsupported for sub-byte samples")
    if photometric not in PHOTOMETRICS:
        raise CodecError(f"unsupported TIFF photometric {photometric}")
    if bits not in (1, 2, 4, 8, 16) or predictor not in (1, 2) or \
            not 1 <= orientation <= 8 or endian not in ("<", ">"):
        raise ValueError(f"bad TIFF signature {sig}")
    if photometric in (2, 6) and spp < 3 or photometric == 5 and spp < 4:
        raise ValueError(f"{spp} samples for photometric {photometric}")


def _wrap32(v):
    """int64 -> the int32 value with two's-complement wrap-around."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def tiff_transform_plain(rows, sig, cmaps=None):
    """(N, H, rowbytes) uint8 rows -> (N, H', W', 4) uint8 rgba; `cmaps`
    (N, 1 << bits, 3) uint8 for photometric 3."""
    _validate(rows, sig)
    (width, height, spp, bits, photometric, predictor, orientation,
     endian, has_extras) = sig
    n = rows.shape[0]
    maxv = (1 << bits) - 1
    r = rows.to(torch.int64)
    if bits == 16:
        b = r.reshape(n, height, -1, 2)
        hi, lo = (b[..., 1], b[..., 0]) if endian == "<" else \
            (b[..., 0], b[..., 1])
        samples = ((hi << 8) | lo)[:, :, :width * spp]
    elif bits == 8:
        samples = r[:, :, :width * spp]
    else:
        per = 8 // bits
        shifts = torch.arange(per - 1, -1, -1, dtype=torch.int64,
                              device=rows.device) * bits
        ex = ((r[..., None] >> shifts) & maxv).reshape(n, height, -1)
        samples = ex[:, :, :width * spp]
    samples = samples.reshape(n, height, width, spp)
    if predictor == 2:
        samples = torch.cumsum(samples, dim=2) % (1 << bits)

    def to8(x):
        if bits == 16:
            return x >> 8
        if bits == 8:
            return x
        return (x * 255) // maxv

    alpha = None
    if photometric in (0, 1):
        grey = to8(samples[..., 0])
        if photometric == 0:
            grey = 255 - grey
        rgb = grey[..., None].expand(n, height, width, 3)
        if spp > 1 and has_extras:
            alpha = to8(samples[..., 1])
    elif photometric == 2:
        rgb = to8(samples[..., :3])
        if spp > 3:
            alpha = to8(samples[..., 3])
    elif photometric == 3:
        img = torch.arange(n, device=rows.device)[:, None, None]
        rgb = cmaps.to(torch.int64)[img, samples[..., 0]]
    elif photometric == 5:
        c8 = to8(samples[..., :4])
        k = 255 - c8[..., 3:4]
        rgb = (255 - c8[..., :3]) * k // 255
        if spp > 4:
            alpha = to8(samples[..., 4])
    else:
        y = samples[..., 0]
        cb = samples[..., 1] - 128
        cr = samples[..., 2] - 128
        rr = y + (_wrap32(91881 * cr + 32768) >> 16)
        gg = y - (_wrap32(22554 * cb + 46802 * cr + 32768) >> 16)
        bb = y + (_wrap32(116130 * cb + 32768) >> 16)
        rgb = torch.stack([rr, gg, bb], -1).clamp(0, 255)
    if alpha is None:
        alpha = torch.full((n, height, width), 255, dtype=torch.int64,
                           device=rows.device)
    out = torch.cat([rgb, alpha[..., None]], dim=-1).to(torch.uint8)
    if orientation == 2:
        out = out.flip(2)
    elif orientation == 3:
        out = out.flip(1, 2)
    elif orientation == 4:
        out = out.flip(1)
    elif orientation >= 5:
        out = out.transpose(1, 2)
        if orientation == 6:
            out = out.flip(2)
        elif orientation == 7:
            out = out.flip(1, 2)
        elif orientation == 8:
            out = out.flip(1)
    return out.contiguous()


def tiff_transform(rows, sig, cmaps=None):
    """(N, H, rowbytes) uint8 rows of signature `sig` -> (N, H', W', 4)
    uint8 rgba on the same device. Launches K16 for CUDA tensors; the
    plain version runs only for CPU tensors."""
    if rows.device.type == "cpu":
        return tiff_transform_plain(rows, sig, cmaps)
    require_cuda(rows, "K16")
    _validate(rows, sig)
    (width, height, spp, bits, photometric, predictor, orientation,
     endian, has_extras) = sig
    n = rows.shape[0]
    if photometric == 3:
        if cmaps is None or cmaps.device != rows.device or \
                cmaps.dtype != torch.uint8 or \
                tuple(cmaps.shape) != (n, 1 << bits, 3):
            raise TypeError(f"K16 takes (N, {1 << bits}, 3) uint8 colormaps "
                            f"on the rows' device")
        cmaps = cmaps.contiguous()
    rows = rows.contiguous()
    out = torch.empty(out_shape(n, sig), dtype=torch.uint8,
                      device=rows.device)
    KERNELS["tiff_transform"](
        ptr(rows), n, height, width, rows.shape[2], spp, bits, photometric,
        predictor, orientation, int(endian == ">"), int(bool(has_extras)),
        None if photometric != 3 else ptr(cmaps), ptr(out),
        stream_of(rows))
    return out


ROUTES = ("generic", "straight", "transposed")
_INFO = ("registers", "local_bytes", "shared_bytes", "threads",
         "blocks_per_sm")


def kernel_info(sig) -> dict:
    """The build of the K16 kernel that signature `sig` launches, as the
    card reports it: registers and local (spill) bytes a thread, shared
    bytes and threads a block, resident blocks a multiprocessor, and its
    route (the straight or transposed fast kernel, or the generic one).
    Launches nothing and counts no launch."""
    import ctypes

    from ..kernels._build import library

    (_w, _h, spp, bits, photometric, predictor, orientation, _endian,
     has_extras) = sig
    vals = (ctypes.c_int * 6)()
    rc = library().picha_tiff_transform_info(
        spp, bits, photometric, predictor, orientation, int(bool(has_extras)),
        vals)
    if rc != 0:
        raise RuntimeError(f"picha_tiff_transform_info: CUDA error {rc}")
    return {**dict(zip(_INFO, vals[:5])), "route": ROUTES[vals[5]]}
