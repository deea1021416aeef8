"""Batched JPEG transcode on one CUDA device: the throughput path.

Counterpart of `picha_tpu/pipeline/jpeg_batch.py` for the all-device
configurations

    JpegBatchPipeline(width, height, encode_quality=85,
                      encode_backend="device", fused=True|False,
                      upload="scan")

Host: header parse (`parse_baseline`) and the scan wire (`scan_wire`,
over the reference's `ScanBatch`), both the reference's own numpy
code. Device, per same-signature batch: one coalesced pinned upload ->
`wire_unpack` -> Huffman decode -> `split_planes` -> pixel stages ->
encoder front (kernel K2) -> Huffman scan encode (kernel K3). The
decode is kernel K1 (one thread per restart segment) for batches that
carry restart markers, and the speculative chunked decoder, kernels
K4 + K5, for the rest: scans without restart markers, and restart scans
whose segments are too long or too few for one lane each. The pixel
stages are the reference's `pixel_stages`: with `fused=True` the
folded dequant+IDCT+upsample+resize matmuls; with `fused=False` the
staged, libjpeg-exact decode (dequant+IDCT, kernel K6; fancy upsample +
colour, kernel K7) and then the separable resize (kernel K8, width pass
then height pass). Host again: read back the byte counts and the used
prefix of the scan buffer, prepend the cached header.

Ported options: `fused` True and False; `normalize` (float32 images on
the 0-1 scale, as the reference's training output); `upload` "scan"
(and "dense", which the scan fallback goes through); `encode_backend`
"device" (and "host", the overflow target); `encode_quality=None`
(uint8 images out). Everything else raises NotImplementedError naming
its ROADMAP.md item.

The reference's content fallbacks stay, each counted on the instance:
`scan_fallbacks` (decoder `ok` false: a chunked decode that did not
converge within its pass budget, or a lane that ran out of its symbol
budget -> host libjpeg entropy decode + dense upload through the same
device stages), `overflow_retries` (encode overflow -> one retry at
twice the quality-derived cap) and `overflow_fallbacks` (-> host
libjpeg encode).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from picha_tpu.native import lib as native
from picha_tpu.ops.jpeg_fused import IDENTITY, component_weights
from picha_tpu.ops.jpeg_huffman_decode_tpu import prep_tables, split_indices
from picha_tpu.ops.jpeg_huffman_tpu import _mcu_layout, assemble
from picha_tpu.ops.jpeg_scan import ScanInfo, mcu_slot_tables, parse_baseline
from picha_tpu.ops.jpeg_tpu import _idct_kron, quality_tables
from picha_tpu.ops.resize import parse_resize_options

from ..ops.jpeg import build_decode_stage, encode_blocks
from ..ops.jpeg_fused import fused_decode_resize, pack_u8
from ..ops.jpeg_huffman import (ScanLayout, code_table, jpeg_header,
                                scan_encode)
from ..ops.jpeg_huffman_decode import (decode_scan, scan_wire, split_planes,
                                       wire_unpack)
from ..ops.resize import INV255, resize_windowed, window_tensors
from ..runtime.device import resolve_device

# -- batching helpers ------------------------------------------------------
# Same semantics as picha_tpu.pipeline.jpeg_batch's helpers of these
# names (tests pin the agreement). They are restated here because
# importing that module runs picha_tpu.pipeline's package init, which
# imports jax.


def signature(co):
    """Shape signature (width, height, colour space, comp_sig) of a
    parsed scan or a host-decoded coefficient set."""
    if isinstance(co, ScanInfo):
        return (co.width, co.height, co.color_space, co.comp_sig)
    return (co.width, co.height, co.color_space,
            tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                  for c in co.comps))


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
    component (fused path), the resize windows ((starts, taps) for the
    width, then the height axis; staged path with a resize target), the
    scan decoder's slot->component table and split indices, the
    Kronecker DCT (the staged IDCT and the encoder's fDCT), and (when
    encoding) the quantisation tables, the scan block layout and the
    Huffman code table."""
    weights: Optional[list]
    windows: Optional[tuple]
    comp_of: torch.Tensor
    split_idx: list
    kron: torch.Tensor
    qluma: Optional[torch.Tensor]
    qchroma: Optional[torch.Tensor]
    layout: Optional[ScanLayout]
    tab: Optional[torch.Tensor]


def fused_weights(comp_sig, width, height, out_w, out_h, filter_name,
                  fscale):
    """Per-component (Th (out_w, bw, 8), Tv (out_h, bh, 8)) numpy
    folds, with the geometry picha_tpu.ops.jpeg_fused.fused_decode_resize
    gives `component_weights`."""
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
                     fused: bool = True):
    """The path's numpy constants (picha_tpu's) -> cached device tensors
    for one signature and configuration."""
    width, height, _cs, comp_sig = sig

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    weights = windows = None
    if fused:
        fw, fh, fname = ((out_w, out_h, filter) if out_w is not None
                         else (width, height, IDENTITY))
        weights = [(dev(th, torch.float32), dev(tv, torch.float32))
                   for th, tv in fused_weights(comp_sig, width, height, fw,
                                               fh, fname, fscale)]
    elif out_w is not None:
        windows = (window_tensors(out_w, width, filter, fscale, device),
                   window_tensors(out_h, height, filter, fscale, device))
    comp_of = dev(mcu_slot_tables(comp_sig), torch.int32)
    split_idx = [dev(i, torch.int64) for i in split_indices(comp_sig)]
    kron = dev(_idct_kron(), torch.float32)
    enc = [None] * 4
    if quality is not None:
        qluma, qchroma = quality_tables(quality)
        channels = 1 if len(comp_sig) == 1 else 3
        ew, eh = (out_w, out_h) if out_w is not None else (width, height)
        layout = ScanLayout(*(dev(a, torch.int32) for a in _mcu_layout(
            resized_comp_sig(eh, ew, channels))))
        enc = [dev(qluma, torch.int32), dev(qchroma, torch.int32), layout,
               dev(code_table(), torch.int32)]
    return DeviceConstants(weights, windows, comp_of, split_idx, kron, *enc)


# -- the device graph ---------------------------------------------------------

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
    if consts.windows is None:
        return rgb.to(torch.float32) * INV255 if normalize else rgb
    if normalize:
        # clip resize overshoot so staged and fused agree
        return resize_windowed(rgb, consts.windows).clamp(0.0, 1.0)
    return resize_windowed(rgb, consts.windows, out_scale=255.0)


def device_graph(sig, args, consts: DeviceConstants, scan_ks=None,
                 encode: bool = True, byte_cap: Optional[int] = None,
                 fused: bool = True, normalize: bool = False):
    """One batch through the device stages.

    args: [wire] (scan upload) or per-component coefficient planes then
    (N, 1, 1, 64) qtables (dense upload), on the device. Returns
    (scan (N, byte_cap) uint8, nbytes (N,) int32) when `encode`, else
    the (N, H, W, C) images, uint8 or (`normalize`) float32; scan
    uploads return (result, ok)."""
    comp_sig = sig[3]
    n = len(comp_sig)
    ok = None
    if scan_ks is not None:
        dec_args, qtabs = wire_unpack(args[0], scan_ks, n)
        scan_out, ok = decode_scan(dec_args, scan_ks, consts.comp_of)
        coefs = split_planes(scan_out, comp_sig, consts.split_idx)
    else:
        coefs, qtabs = args[:n], args[n:2 * n]
    px = pixel_stages(sig, coefs, qtabs, consts, fused, normalize)
    if normalize:
        result = px
    elif not encode:
        result = px if px.dtype == torch.uint8 else pack_u8(px)
    else:
        blocks = encode_blocks(px.to(torch.float32), consts.qluma,
                               consts.qchroma, consts.kron)
        result = scan_encode(blocks, consts.layout, consts.tab, byte_cap)
    return result if ok is None else (result, ok)


def _unported(what: str, where: str):
    return NotImplementedError(
        f"{what} is not ported to picha_tpu_torch yet: ROADMAP.md {where}")


class JpegBatchPipeline:
    """decode -> (resize) -> {uint8 | re-encoded JPEG} over
    homogeneous-signature batches on one device (see module doc)."""

    def __init__(self, width: Optional[int] = None,
                 height: Optional[int] = None,
                 filter: Optional[str] = None,
                 filter_scale: Optional[float] = None,
                 normalize: bool = False,
                 encode_quality: Optional[int] = None,
                 encode_backend: str = "device",
                 upload: str = "scan",
                 fused: bool = True,
                 scan_byte_cap: Optional[int] = None,
                 device="cuda"):
        if normalize and encode_quality is not None:
            raise ValueError("normalize=True returns float32 images and "
                             "takes no encode_quality")
        if encode_backend == "raw420":
            raise _unported("encode_backend='raw420'",
                            "queue 1 item 1 (Slice A)")
        if encode_backend not in ("device", "host"):
            raise _unported(f"encode_backend={encode_backend!r}",
                            "queue 1 item 5")
        if upload not in ("scan", "dense"):
            raise _unported(f"upload={upload!r}", "queue 1 item 5")
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
        self._upload = upload
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
        """upload='scan': parsed headers (the device decodes the scan);
        files the device decoder cannot take (progressive, arithmetic,
        too many table rows, oversized batch) go through host libjpeg."""
        if self._upload == "scan":
            infos = [parse_baseline(bytes(b)) for b in bufs]
            if all(i is not None for i in infos):
                uniq = set()
                for i in infos:
                    limit, delta, hv = prep_tables(i)
                    for t in range(6):
                        uniq.add((limit[t].tobytes(), delta[t].tobytes(),
                                  hv[t].tobytes()))
                scan_bytes = sum(
                    sum(len(s) for s in i.segments) for i in infos)
                if len(uniq) <= 256 and scan_bytes <= 2**27:
                    for i, b in zip(infos, bufs):
                        i.src = b
                    return infos
        return self._host_decode(bufs)

    @staticmethod
    def _host_decode(bufs):
        return [native.JpegCoefficients(bytes(b)) for b in bufs]

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """One host array -> the device (pinned, asynchronous on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def stack_bucket(self, cos):
        """Same-signature coefficient sets -> (sig, dense host arrays):
        per-component (N, bh, bw, 64) int16 planes, then (N, 1, 1, 64)
        int32 qtables."""
        sig = signature(cos[0])
        n = len(cos[0].comps)
        args = [np.stack([co.comps[i]["coefs"] for co in cos])
                for i in range(n)]
        args += [np.stack([co.comps[i]["qtable"] for co in cos]).astype(
            np.int32)[:, None, None, :] for i in range(n)]
        return sig, args

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

    def run_bucket(self, sig, args, scan_ks=None):
        """Device arrays of one batch -> device output (see
        device_graph)."""
        encode = (self._encode_quality is not None
                  and self._encode_backend == "device")
        cap = self._scan_cap_for(sig) if encode else None
        return device_graph(sig, args, self.constants(sig), scan_ks=scan_ks,
                            encode=encode, byte_cap=cap, fused=self._fused,
                            normalize=self._normalize)

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
        encode_quality is set, else an (N, H, W, C) uint8 tensor."""
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
        with the host libjpeg encoder (same device pixel stages)."""
        self.overflow_fallbacks += 1
        if self._overflow_clone is None:
            self._overflow_clone = JpegBatchPipeline(
                width=self._width, height=self._height, filter=self._filter,
                filter_scale=self._fscale,
                encode_quality=self._encode_quality, encode_backend="host",
                upload="dense", fused=self._fused, device=self.device)
        clone = self._overflow_clone
        if isinstance(cos[0], ScanInfo):
            cos = self._host_decode([i.src for i in cos])
        return clone._finish(*clone._process(cos))

    def _process(self, cos):
        """Homogeneous batch -> (sig, device output)."""
        if isinstance(cos[0], ScanInfo):
            srcs = [i.src for i in cos]
            try:
                ks, wire = scan_wire(cos)
            except ValueError:
                # ScanBatch's own capacity gates: host decode instead
                return self._process(self._host_decode(srcs))
            sig = signature(cos[0])
            out = self.run_bucket(sig, [self._put(wire)], scan_ks=ks)
            return sig, ("scan", out, srcs)
        sig, args = self.stack_bucket(cos)
        return sig, self.run_bucket(sig, [self._put(a) for a in args])

    def _finish(self, sig, out):
        """Device output -> encoded bytes or the uint8 image tensor."""
        if isinstance(out, tuple) and len(out) == 3 and out[0] == "scan":
            _, (res, okf), srcs = out
            if not bool(okf):
                return self._scan_fallback(srcs)
            out = res
        if self._encode_quality is None:
            return out
        if self._encode_backend == "host":
            q = self._encode_quality
            return [native.jpeg_encode(img, q) for img in out.cpu().numpy()]
        return self.scan_finish(out, sig)

    def _scan_fallback(self, bufs):
        """The device decoder flagged the batch (malformed stream, or no
        fixpoint within the pass budget): host libjpeg entropy decode,
        then the dense upload through the same device stages."""
        self.scan_fallbacks += 1
        sig, args = self.stack_bucket(self._host_decode(bufs))
        return self._finish(sig, self.run_bucket(
            sig, [self._put(a) for a in args]))

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
        channels = 1 if len(sig[3]) == 1 else 3
        header = jpeg_header(ew, eh, resized_comp_sig(eh, ew, channels),
                             self._encode_quality)
        return [assemble(header, host[i], int(nb[i]))
                for i in range(host.shape[0])]

    def _call_mixed(self, cos):
        """Heterogeneous batch: per-signature sub-batches (padded to a
        multiple of 8), reassembled in input order."""
        if self._encode_quality is None and (self._width is None
                                             or self._height is None):
            raise ValueError(
                "mixed-signature batch without a resize target has no "
                "common output shape; set width/height or encode_quality")
        results = [None] * len(cos)
        for _sig, idxs, group in bucket_by_signature(cos):
            padded, _n = pad_group(group)
            out = self._run_with_retry(padded)
            for j, i in enumerate(idxs):
                results[i] = out[j]
        if self._encode_quality is None:
            cmax = max(r.shape[-1] for r in results)
            results = [r.expand(*r.shape[:-1], cmax)
                       if r.shape[-1] != cmax else r for r in results]
            return torch.stack(results)
        return results
