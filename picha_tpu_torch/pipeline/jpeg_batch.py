"""Batched JPEG transcode on one CUDA device: the throughput path.

Counterpart of `picha_tpu/pipeline/jpeg_batch.py` for the all-device
configurations

    JpegBatchPipeline(width, height, encode_quality=85,
                      encode_backend="device", fused=True|False,
                      upload="scan")

Host: header parse (`parse_baseline`) and the scan wire (`scan_wire`,
`ops/scan_batch.py::ScanBatch`), the port's numpy copies of the
reference's host prep. Device, per same-signature batch: one coalesced
pinned upload -> `wire_unpack` -> Huffman decode -> `split_planes` ->
pixel stages -> encoder front (kernel K2) -> Huffman scan encode (kernel
K3). The decode is kernel K1 (one thread per restart segment) for
batches that carry restart markers, and the speculative chunked decoder,
kernels K4 + K5, for the rest. The pixel stages are the reference's
`pixel_stages`: with `fused=True` the folded dequant+IDCT+upsample+resize
matmuls; with `fused=False` the staged, libjpeg-exact decode
(dequant+IDCT, kernel K6; fancy upsample + colour, kernel K7) and then
the separable resize (kernel K8, width pass then height pass). Host
again: read back the byte counts and the used prefix of the scan buffer,
prepend the header.

Ported options: `fused` False (the default, as the reference's) and
True; `normalize` (float32 images on
the 0-1 scale, as the reference's training output; with `encode_quality`
set too, the normalized images are returned, as the reference's batch
graph returns them before its encode); `upload="scan"`;
`encode_backend` "device" (and "host", the overflow target);
`encode_quality=None` (uint8 images out). Everything else raises
NotImplementedError naming its ROADMAP.md item; `upload="dense"` among
them, since the port has no host source of coefficients.

The reference's content fallbacks stay, each counted on the instance.
`scan_fallbacks` counts the batches the device decoder does not take:
files `parse_baseline` refuses (progressive, CMYK, ...), batches past
`ScanBatch`'s capacity gates, and a decoder `ok` that is false (a
chunked decode that did not converge, a lane that ran out of its symbol
budget). Such a batch is decoded to pixels on the host
(`codecs/jpeg_host.py`, Pillow's libjpeg), uploaded as uint8 and taken
through the device pixel stages that follow a decode: the K8 resize
(whatever `fused` says), then K2 -> K3, the pack or the normalisation.
`overflow_retries` counts an encode overflow retried once at twice the
quality-derived cap, `overflow_fallbacks` the batches then encoded on
the host from the same device pixels (`jpeg_host.encode`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..codecs import jpeg_host
from ..ops.jpeg import _idct_kron, build_decode_stage, encode_blocks, pack_u8
from ..ops.jpeg import quality_tables
from ..ops.jpeg_fused import IDENTITY, component_weights, fused_decode_resize
from ..ops.jpeg_huffman import (ScanLayout, _mcu_layout, assemble,
                                code_table, jpeg_header, scan_encode)
from ..ops.jpeg_huffman_decode import (decode_scan, scan_wire, split_planes,
                                       wire_unpack)
from ..ops.jpeg_scan import mcu_slot_tables, parse_baseline
from ..ops.resize import INV255, resize_windowed, window_tensors
from ..ops.resize_weights import parse_resize_options
from ..ops.scan_batch import prep_tables, split_indices
from ..runtime.device import resolve_device, upload


class HostPixels(NamedTuple):
    """A file decoded on the host (the device decoder does not take it):
    (H, W, C) uint8 pixels and the source bytes."""
    pixels: np.ndarray
    src: bytes


HOST = "host"   # the colour-space slot of a HostPixels signature


def host_decode(bufs):
    """JPEG bytes -> HostPixels through Pillow's libjpeg."""
    return [HostPixels(jpeg_host.decode_rgb(b), bytes(b)) for b in bufs]


# -- batching helpers ------------------------------------------------------
# Same semantics as picha_tpu.pipeline.jpeg_batch's helpers of these
# names (tests pin the agreement).


def signature(co):
    """Shape signature (width, height, colour space, comp_sig) of a
    parsed scan; (width, height, HOST, channels) of host pixels."""
    if isinstance(co, HostPixels):
        h, w, c = co.pixels.shape
        return (w, h, HOST, c)
    return (co.width, co.height, co.color_space, co.comp_sig)


def channels_of(sig) -> int:
    """Channels of a signature's decoded image: 1 (grey) or 3."""
    if sig[2] == HOST:
        return sig[3]
    return 1 if len(sig[3]) == 1 else 3


def resized_comp_sig(h: int, w: int, channels: int):
    """Component block grids of the re-encoded image (4:2:0 colour)."""
    def cdiv(a, b):
        return -(-a // b)

    if channels == 1:
        return ((cdiv(h, 8), cdiv(w, 8), 1, 1),)
    ch, cw = cdiv(h, 2), cdiv(w, 2)
    return ((cdiv(h, 8), cdiv(w, 8), 2, 2),
            (cdiv(ch, 8), cdiv(cw, 8), 1, 1),
            (cdiv(ch, 8), cdiv(cw, 8), 1, 1))


def bucket_by_signature(cos):
    """[(sig, input indices, group)] in first-appearance order."""
    order = {}
    for i, co in enumerate(cos):
        order.setdefault(signature(co), []).append(i)
    return [(sig, idxs, [cos[i] for i in idxs])
            for sig, idxs in order.items()]


def pad_group(group, multiple: int = 8):
    """Pad a bucket to a size multiple by repeating its last element.
    Returns (padded_group, real_count)."""
    n = len(group)
    target = -(-n // multiple) * multiple
    return list(group) + [group[-1]] * (target - n), n


# -- constants ---------------------------------------------------------------

class DeviceConstants(NamedTuple):
    """Per-signature device tensors: the fused (th, tv) weights per
    component (fused path of a scan), the resize windows ((starts, taps)
    for the width, then the height axis; staged path or host pixels,
    with a resize target), the scan decoder's slot->component table and
    split indices (scans), the Kronecker DCT (the staged IDCT and the
    encoder's fDCT), and (when encoding) the quantisation tables, the
    scan block layout and the Huffman code table."""
    weights: Optional[list]
    windows: Optional[tuple]
    comp_of: Optional[torch.Tensor]
    split_idx: Optional[list]
    kron: torch.Tensor
    qluma: Optional[torch.Tensor]
    qchroma: Optional[torch.Tensor]
    layout: Optional[ScanLayout]
    tab: Optional[torch.Tensor]


def fused_weights(comp_sig, width, height, out_w, out_h, filter_name,
                  fscale):
    """Per-component (Th (out_w, bw, 8), Tv (out_h, bh, 8)) numpy
    folds, with the geometry of the reference's fused_decode_resize."""
    max_h = max(s[2] for s in comp_sig)
    max_v = max(s[3] for s in comp_sig)
    out = []
    for _bh, _bw, hs, vs in comp_sig:
        dw = -(-width * hs // max_h)
        dh = -(-height * vs // max_v)
        fx, fy = max_h // hs, max_v // vs
        th = component_weights(out_w, width, dw, fx, filter_name, fscale,
                               fx == 2 and fy in (1, 2))
        tv = component_weights(out_h, height, dh, fy, filter_name, fscale,
                               fy == 2 and fx in (1, 2))
        out.append((th, tv))
    return out


def device_constants(sig, out_w, out_h, filter, fscale, quality, device,
                     fused: bool = False):
    """The path's numpy constants -> cached device tensors for one
    signature and configuration."""
    width, height, cs, comp_sig = sig
    host = cs == HOST

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    weights = windows = comp_of = split_idx = None
    if fused and not host:
        fw, fh, fname = ((out_w, out_h, filter) if out_w is not None
                         else (width, height, IDENTITY))
        weights = [(dev(th, torch.float32), dev(tv, torch.float32))
                   for th, tv in fused_weights(comp_sig, width, height, fw,
                                               fh, fname, fscale)]
    elif out_w is not None:
        windows = (window_tensors(out_w, width, filter, fscale, device),
                   window_tensors(out_h, height, filter, fscale, device))
    if not host:
        comp_of = dev(mcu_slot_tables(comp_sig), torch.int32)
        split_idx = [dev(i, torch.int64) for i in split_indices(comp_sig)]
    kron = dev(_idct_kron(), torch.float32)
    enc = [None] * 4
    if quality is not None:
        qluma, qchroma = quality_tables(quality)
        ew, eh = (out_w, out_h) if out_w is not None else (width, height)
        layout = ScanLayout(*(dev(a, torch.int32) for a in _mcu_layout(
            resized_comp_sig(eh, ew, channels_of(sig)))))
        enc = [dev(qluma, torch.int32), dev(qchroma, torch.int32), layout,
               dev(code_table(), torch.int32)]
    return DeviceConstants(weights, windows, comp_of, split_idx, kron, *enc)


# -- the device graph ---------------------------------------------------------

def resized_pixels(rgb, windows, normalize: bool = False):
    """Decoded uint8 (N, H, W, C) images -> the resize (K8, width then
    height pass) when `windows` is set: float32 on the 0-1 scale
    clipped to [0, 1] (`normalize`), else on the 0-255 scale for the
    pack or the encoder front. Without a resize: the uint8 images, or
    v * f32(1/255) (`normalize`)."""
    if windows is None:
        return rgb.to(torch.float32) * INV255 if normalize else rgb
    if normalize:
        # clip resize overshoot so staged and fused agree
        return resize_windowed(rgb, windows).clamp(0.0, 1.0)
    return resize_windowed(rgb, windows, out_scale=255.0)


def pixel_stages(sig, coefs, qtabs, consts: DeviceConstants,
                 fused: bool, normalize: bool = False):
    """The reference's `pixel_stages` before the encode: coefficients ->
    either (N, H', W', C) float32 normalised to 0-1 (`normalize`), or
    the pixels on the 0-255 scale that the u8 pack or the encoder front
    takes: float32 (fused, or staged with a resize) or the staged
    decode's uint8 (staged without a resize)."""
    width, height, color_space, comp_sig = sig
    if fused:
        f255 = fused_decode_resize(comp_sig, color_space, coefs, qtabs,
                                   consts.weights)
        if normalize:
            return f255.clamp(0.0, 255.0) * INV255
        return f255
    rgb = build_decode_stage(comp_sig, color_space, width, height)(
        coefs, qtabs, consts.kron)
    return resized_pixels(rgb, consts.windows, normalize)


def output_stages(px, consts: DeviceConstants, encode: bool,
                  byte_cap: Optional[int], normalize: bool):
    """Pixel-stage output -> the batch's result: the normalised floats
    as they are, the uint8 images (pack) or the encoded scans (K2 ->
    K3: (scan (N, byte_cap) uint8, nbytes (N,) int32))."""
    if normalize:
        return px
    if not encode:
        return px if px.dtype == torch.uint8 else pack_u8(px)
    blocks = encode_blocks(px.to(torch.float32), consts.qluma,
                           consts.qchroma, consts.kron)
    return scan_encode(blocks, consts.layout, consts.tab, byte_cap)


def device_graph(sig, wire, consts: DeviceConstants, scan_ks,
                 encode: bool = True, byte_cap: Optional[int] = None,
                 fused: bool = False, normalize: bool = False):
    """One scan batch through the device stages: the uploaded wire ->
    (result, ok), result as `output_stages` gives it."""
    dec_args, qtabs = wire_unpack(wire, scan_ks, len(sig[3]))
    scan_out, ok = decode_scan(dec_args, scan_ks, consts.comp_of)
    coefs = split_planes(scan_out, sig[3], consts.split_idx)
    px = pixel_stages(sig, coefs, qtabs, consts, fused, normalize)
    return output_stages(px, consts, encode, byte_cap, normalize), ok


def _unported(what: str, where: str):
    return NotImplementedError(
        f"{what} is not ported to picha_tpu_torch yet: ROADMAP.md {where}")


class JpegBatchPipeline:
    """decode -> (resize) -> {uint8 | normalized | re-encoded JPEG} over
    homogeneous-signature batches on one device (see module doc)."""

    def __init__(self, width: Optional[int] = None,
                 height: Optional[int] = None,
                 filter: Optional[str] = None,
                 filter_scale: Optional[float] = None,
                 normalize: bool = False,
                 encode_quality: Optional[int] = None,
                 encode_backend: str = "device",
                 upload: str = "scan",
                 fused: bool = False,
                 scan_byte_cap: Optional[int] = None,
                 device="cuda"):
        if encode_backend == "raw420":
            raise _unported("encode_backend='raw420'",
                            "queue 1 item 1 (Slice A)")
        if encode_backend not in ("device", "host"):
            raise _unported(f"encode_backend={encode_backend!r}",
                            "queue 1 item 5")
        if upload != "scan":
            raise _unported(f"upload={upload!r} (host coefficients)",
                            "queue 1 item 5")
        opts = {}
        if filter is not None:
            opts["filter"] = filter
        if filter_scale is not None:
            opts["filterScale"] = filter_scale
        self._filter, self._fscale = parse_resize_options(opts)
        self._width, self._height = width, height
        self._normalize = normalize
        self._fused = fused
        self._encode_quality = encode_quality
        self._encode_backend = encode_backend
        self._scan_byte_cap = scan_byte_cap
        self._cap_boost = 1
        self._overflow_clone = None
        self._consts = {}
        self.device = resolve_device(device)
        self.scan_fallbacks = 0
        self.overflow_retries = 0
        self.overflow_fallbacks = 0

    # -- host stage ----------------------------------------------------------

    def entropy_decode(self, bufs):
        """Parsed headers (the device decodes the scans), or, when a file
        is one the device decoder does not take (progressive,
        arithmetic, CMYK, too many table rows, oversized batch), the
        whole batch decoded to pixels on the host (counted)."""
        infos = [parse_baseline(bytes(b)) for b in bufs]
        if all(i is not None for i in infos):
            uniq = set()
            for i in infos:
                limit, delta, hv = prep_tables(i)
                for t in range(6):
                    uniq.add((limit[t].tobytes(), delta[t].tobytes(),
                              hv[t].tobytes()))
            scan_bytes = sum(sum(len(s) for s in i.segments) for i in infos)
            if len(uniq) <= 256 and scan_bytes <= 2**27:
                for i, b in zip(infos, bufs):
                    i.src = b
                return infos
        self.scan_fallbacks += 1
        return host_decode(bufs)

    # -- device stage --------------------------------------------------------

    def constants(self, sig) -> DeviceConstants:
        quality = (self._encode_quality
                   if self._encode_backend == "device" else None)
        key = (sig, quality)
        if key not in self._consts:
            self._consts[key] = device_constants(
                sig, self._width, self._height, self._filter, self._fscale,
                quality, self.device, fused=self._fused)
        return self._consts[key]

    def _encodes(self) -> bool:
        return (self._encode_quality is not None and not self._normalize
                and self._encode_backend == "device")

    def run_bucket(self, sig, wire, scan_ks):
        """The uploaded wire of one scan batch -> (device output, ok)
        (see device_graph)."""
        encode = self._encodes()
        cap = self._scan_cap_for(sig) if encode else None
        return device_graph(sig, wire, self.constants(sig), scan_ks,
                            encode=encode, byte_cap=cap, fused=self._fused,
                            normalize=self._normalize)

    def run_pixels(self, sig, rgb):
        """Uploaded host-decoded uint8 images of one batch -> the device
        output (the resize, then as `output_stages`)."""
        encode = self._encodes()
        consts = self.constants(sig)
        px = resized_pixels(rgb, consts.windows, self._normalize)
        return output_stages(px, consts, encode,
                             self._scan_cap_for(sig) if encode else None,
                             self._normalize)

    def _scan_cap_for(self, sig) -> int:
        if self._scan_byte_cap is not None:
            return self._scan_byte_cap
        ew = self._width if self._width is not None else sig[0]
        eh = self._height if self._height is not None else sig[1]
        # ~1.4x headroom over dense natural content at the quality;
        # an overflow retries once at twice this (_run_with_retry)
        q = self._encode_quality
        frac = 3 if q is None or q <= 88 else (5 if q <= 95 else 10)
        frac *= self._cap_boost
        return max(1 << 16, -(-(ew * eh * frac // 16) // 4096) * 4096)

    def __call__(self, bufs: Sequence[bytes]):
        """Full pipeline for a batch: a list of JPEG bytes when
        encode_quality is set (and not normalize), else an (N, H, W, C)
        uint8 or (normalize) float32 tensor."""
        cos = self.entropy_decode(bufs)
        if len({signature(co) for co in cos}) != 1:
            return self._call_mixed(cos)
        return self._run_with_retry(cos)

    def _run_with_retry(self, cos):
        try:
            return self._finish(*self._process(cos))
        except OverflowError:
            if self._scan_byte_cap is None and self._cap_boost == 1:
                self._cap_boost = 2
                self.overflow_retries += 1
                try:
                    return self._finish(*self._process(cos))
                except OverflowError:
                    pass
            return self._overflow_fallback(cos)

    def _overflow_fallback(self, cos):
        """Redo a batch whose device encode overflowed through a clone
        that encodes on the host (same device decode and pixel
        stages)."""
        self.overflow_fallbacks += 1
        if self._overflow_clone is None:
            self._overflow_clone = JpegBatchPipeline(
                width=self._width, height=self._height, filter=self._filter,
                filter_scale=self._fscale,
                encode_quality=self._encode_quality, encode_backend="host",
                fused=self._fused, device=self.device)
        clone = self._overflow_clone
        return clone._finish(*clone._process(cos))

    def _process(self, cos):
        """Homogeneous batch -> (sig, device output)."""
        if isinstance(cos[0], HostPixels):
            sig = signature(cos[0])
            rgb = upload(np.stack([c.pixels for c in cos]), self.device)
            return sig, self.run_pixels(sig, rgb)
        srcs = [i.src for i in cos]
        try:
            ks, wire = scan_wire(cos)
        except ValueError:
            # ScanBatch's own capacity gates: host decode instead
            self.scan_fallbacks += 1
            return self._process(host_decode(srcs))
        sig = signature(cos[0])
        out = self.run_bucket(sig, upload(wire, self.device), ks)
        return sig, ("scan", out, srcs)

    def _finish(self, sig, out):
        """Device output -> encoded bytes or the image tensor."""
        if isinstance(out, tuple) and len(out) == 3 and out[0] == "scan":
            _, (res, okf), srcs = out
            if not bool(okf):
                return self._scan_fallback(srcs)
            out = res
        if self._encode_quality is None or self._normalize:
            return out
        if self._encode_backend == "host":
            q = self._encode_quality
            return [jpeg_host.encode(img, q) for img in out.cpu().numpy()]
        return self.scan_finish(out, sig)

    def _scan_fallback(self, bufs):
        """The device decoder flagged the batch (malformed stream, or no
        fixpoint within the pass budget): host pixel decode, then the
        device stages that follow a decode."""
        self.scan_fallbacks += 1
        return self._finish(*self._process(host_decode(bufs)))

    def scan_finish(self, out, sig):
        """Read back the byte counts, then only the used prefix of the
        scan buffer (64 KiB granules), and prepend the header."""
        scan, nbytes = out
        nb = nbytes.cpu().numpy()
        cap = scan.shape[1]
        if int(nb.max()) > cap:
            raise OverflowError(
                f"device scan encode overflow ({int(nb.max())} > {cap}): "
                "raise scan_byte_cap, lower the quality, or use "
                "encode_backend='host'")
        m = min(cap, -(-int(nb.max()) // 65536) * 65536)
        host = scan[:, :m].cpu().numpy()
        ew = self._width if self._width is not None else sig[0]
        eh = self._height if self._height is not None else sig[1]
        header = jpeg_header(ew, eh,
                             resized_comp_sig(eh, ew, channels_of(sig)),
                             self._encode_quality)
        return [assemble(header, host[i], int(nb[i]))
                for i in range(host.shape[0])]

    def _call_mixed(self, cos):
        """Heterogeneous batch: per-signature sub-batches (padded to a
        multiple of 8), reassembled in input order."""
        tensors = self._encode_quality is None or self._normalize
        if tensors and (self._width is None or self._height is None):
            raise ValueError(
                "mixed-signature batch without a resize target has no "
                "common output shape; set width/height or encode_quality")
        results = [None] * len(cos)
        for _sig, idxs, group in bucket_by_signature(cos):
            padded, _n = pad_group(group)
            out = self._run_with_retry(padded)
            for j, i in enumerate(idxs):
                results[i] = out[j]
        if tensors:
            cmax = max(r.shape[-1] for r in results)
            results = [r.expand(*r.shape[:-1], cmax)
                       if r.shape[-1] != cmax else r for r in results]
            return torch.stack(results)
        return results
