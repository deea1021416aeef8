"""Batched JPEG transcode on one CUDA device: the throughput path.

Counterpart of `picha_tpu/pipeline/jpeg_batch.py`, with the reference's
API and defaults:

    JpegBatchPipeline(width, height, encode_quality=85,
                      encode_backend="tpu" | "device" | "raw420" | "host",
                      fused=False | True,
                      upload="dense" | "scan" | "sparse" | "int8" |
                             "gap8" | "gap4")

Host: header parse (`parse_baseline`). With `upload="scan"` the scan wire
(`scan_wire`, `ops/scan_batch.py::ScanBatch`) goes up as it is and the
device decodes it: one coalesced pinned upload -> `wire_unpack` ->
Huffman decode -> `split_planes`. The decode is kernel K1 (one thread per
restart segment) for batches that carry restart markers, and the
speculative chunked decoder, kernels K4 + K5, for the rest. The
host-coefficient uploads (`upload="dense"`, the reference's default,
and "sparse", "int8", "gap8", "gap4", the reference's :457-476) decode
the scans on the host instead (`ops/coef_host.py`: the host C++ decoder
of `csrc/jpeg_entropy_host.cu` on a thread pool of `num_threads` for a
CUDA device, the numpy `decode_reference` for the CPU), `stack_bucket`
packs them as the reference's wire (dense int16 planes; (index, value)
pairs; int8 bodies + corrections; the gap8 and gap4 wires, the latter two
one coalesced buffer each), and the device restores them
(`ops/coef_restore.py`: kernels K27-K30; the dense planes need none).
Their coefficients are K1's / K4 + K5's, so every upload gives the same
bytes.

Device, per same-signature batch, after the coefficients: the pixel
stages are the reference's `pixel_stages`: with `fused=True` the folded
dequant+IDCT+upsample+resize matmuls; with `fused=False` (the default)
the staged, libjpeg-exact decode (dequant+IDCT, kernel K6; fancy upsample
+ colour, kernel K7) and then the separable resize (kernel K8, width pass
then height pass, in one launch where its tile fits shared memory). Then
the encode backend:
  "tpu" (the default)  encoder front (kernel K2: u8 pack, YCbCr, 4:2:0,
                       fDCT, quantisation); the int16 planes are read
                       back and the host writes the scan
                       (`ops/jpeg_write.py::write_coefficients`, the
                       reference's `native.jpeg_coef_write`);
  "device"             K2, then the Huffman scan encode (kernel K3): the
                       host reads back the byte counts and the used
                       prefix of the scan buffer and prepends the header;
  "raw420"             the 4:2:0 pack (kernel K31: u8 pack, YCbCr, edge
                       pad to 16, 2x2 box downsample) into one (N, bytes)
                       buffer, read back once; the host writes each image
                       (`ops/jpeg_write.py::write_raw420`: libjpeg's
                       islow fDCT, quantisation and Huffman scan, the
                       reference's `native.jpeg_encode_raw420`);
  "host"               the uint8 images are read back and Pillow's
                       libjpeg encodes them (`codecs/jpeg_host.py`).
The host writers of "tpu" and "raw420" are the port's own host C++
(`csrc/jpeg_write_host.cu`, no libjpeg) on the pool for a CUDA device and
their numpy plain versions for the CPU; both give libjpeg's bytes.

Options: `normalize` (float32 images on the 0-1 scale, as the
reference's training output; with `encode_quality` set too, the
normalized images are returned, as the reference's batch graph returns
them before its encode); `num_threads`; `encode_quality=None` (uint8
images out); `scan_byte_cap` (the device encode's buffer).

The reference's content fallbacks stay, each counted on the instance.
`scan_fallbacks` counts the batches the device decoder (or, for the
host-coefficient uploads, the host decoder) does not take: files
`parse_baseline` refuses (progressive, CMYK, ...), batches past
`ScanBatch`'s capacity gates, and a decoder `ok` that is false (a
chunked decode that did not converge, a lane that ran out of its symbol
budget). Such a batch is decoded to pixels on the host
(`codecs/jpeg_host.py`, Pillow's libjpeg), uploaded as uint8 and taken
through the device pixel stages that follow a decode: the K8 resize
(whatever `fused` says), then the encode backend, the pack or the
normalisation. `overflow_retries` counts a "device" encode overflow
retried once at twice the quality-derived cap, `overflow_fallbacks` the
batches then redone, as the reference redoes them (:806-829), through a
clone with `encode_backend="raw420"` and the same upload ("gap4" in
place of "scan", its scans decoded on the host).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..codecs import jpeg_host
from ..ops import coef_host, coef_restore, jpeg_write
from ..ops.jpeg_write import resized_comp_sig
from ..ops.jpeg import _idct_kron, build_decode_stage, encode_blocks, pack_u8
from ..ops.jpeg import quality_tables, yuv420_pack
from ..ops.jpeg_fused import IDENTITY, component_weights, fused_decode_resize
from ..ops.jpeg_huffman import (ScanLayout, _mcu_layout, assemble,
                                code_table, jpeg_header, scan_encode)
from ..ops.jpeg_huffman_decode import (decode_scan, scan_wire, split_planes,
                                       wire_unpack)
from ..ops.jpeg_scan import ScanInfo, mcu_slot_tables, parse_baseline
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


def entropy_decode(bufs: Sequence[bytes],
                   pool: Optional[ThreadPoolExecutor] = None,
                   max_threads: Optional[int] = None,
                   force_libjpeg: bool = False):
    """The reference's host entropy decode (`pipeline/jpeg_batch.py::
    entropy_decode`): JPEG bytes -> `coef_host.JpegCoefficients`, with
    its thread policy (`coef_host.entropy_decode`: segment-parallel when
    the batch is narrower than `max_threads`, image-parallel on `pool`
    otherwise). The decoder is the port's own: the host C++ one where
    the machine has a card (it is built with the kernels), its numpy
    plain version otherwise. It takes baseline Huffman scans; libjpeg's
    route (`force_libjpeg`, and the files only libjpeg takes) is ROADMAP
    queue 1 item 5."""
    if force_libjpeg:
        raise NotImplementedError(
            "entropy_decode: force_libjpeg (libjpeg's decoder) is not "
            "ported yet (ROADMAP queue 1 item 5)")
    infos = [parse_baseline(bytes(b)) for b in bufs]
    if any(i is None for i in infos):
        raise NotImplementedError(
            "entropy_decode: a file the port's host decoder does not take "
            "(progressive, arithmetic or CMYK) needs libjpeg's decoder, "
            "not ported yet (ROADMAP queue 1 item 5)")
    return coef_host.entropy_decode(infos, torch.cuda.is_available(), pool,
                                    max_threads)


# -- batching helpers ------------------------------------------------------
# Same semantics as picha_tpu.pipeline.jpeg_batch's helpers of these
# names (tests pin the agreement).


def signature(co):
    """Shape signature (width, height, colour space, comp_sig) of a
    parsed scan or a coefficient set; (width, height, HOST, channels) of
    host pixels."""
    if isinstance(co, HostPixels):
        h, w, c = co.pixels.shape
        return (w, h, HOST, c)
    return (co.width, co.height, co.color_space, co.comp_sig)


def channels_of(sig) -> int:
    """Channels of a signature's decoded image: 1 (grey) or 3."""
    if sig[2] == HOST:
        return sig[3]
    return 1 if len(sig[3]) == 1 else 3


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
    height pass, `resize_windowed`) when `windows` is set: float32 on the 0-1 scale
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


ENCODE_BACKENDS = ("tpu", "device", "raw420", "host")


def output_stages(px, consts: DeviceConstants, backend: Optional[str],
                  byte_cap: Optional[int], normalize: bool):
    """Pixel-stage output -> the batch's device result: the normalised
    floats as they are; for `backend` None or "host" the uint8 images
    (pack); "device" the encoded scans (K2 -> K3: (scan (N, byte_cap)
    uint8, nbytes (N,) int32)); "tpu" K2's quantised planes (a tuple of
    (N, bh, bw, 64) int16); "raw420" K31's (N, bytes) uint8 4:2:0
    planes."""
    if normalize:
        return px
    if backend in (None, "host"):
        return px if px.dtype == torch.uint8 else pack_u8(px)
    if backend == "raw420":
        return yuv420_pack(px)
    blocks = encode_blocks(px.to(torch.float32), consts.qluma,
                           consts.qchroma, consts.kron)
    if backend == "tpu":
        return blocks
    return scan_encode(blocks, consts.layout, consts.tab, byte_cap)


def device_graph(sig, wire, consts: DeviceConstants, scan_ks,
                 backend: Optional[str] = "device",
                 byte_cap: Optional[int] = None, fused: bool = False,
                 normalize: bool = False):
    """One scan batch through the device stages: the uploaded wire ->
    (result, ok), result as `output_stages` gives it."""
    dec_args, qtabs = wire_unpack(wire, scan_ks, len(sig[3]))
    scan_out, ok = decode_scan(dec_args, scan_ks, consts.comp_of)
    coefs = split_planes(scan_out, sig[3], consts.split_idx)
    px = pixel_stages(sig, coefs, qtabs, consts, fused, normalize)
    return output_stages(px, consts, backend, byte_cap, normalize), ok


UPLOADS = ("scan", "dense", "sparse", "int8", "gap8", "gap4")


def restore_planes(sig, args, sparse_ks=None, int8_ks=None, gap8_ks=None,
                   gap4_ks=None):
    """The uploaded arguments of one host-coefficient batch ->
    (per-component (N, bh, bw, 64) coefficients, qtabs (N, 1, 1, 64)
    int32): the reference's `_jit_batch_graph` branches before its pixel
    stages. `args` as `stack_bucket` gives them, on the device (qtables
    as int32), one wire tensor for gap8 / gap4."""
    comp_sig = sig[3]
    n = len(comp_sig)
    if gap4_ks is not None:
        return coef_restore.unpack_gap4_wire(args[0], gap4_ks, comp_sig)
    if gap8_ks is not None:
        parts, qtabs = coef_restore.unpack_gap8(args[0], gap8_ks, n)
        return tuple(coef_restore.gap8_restore(*p, comp_sig[i][0],
                                               comp_sig[i][1])
                     for i, p in enumerate(parts)), qtabs
    if sparse_ks is not None:
        return tuple(coef_restore.densify(args[2 * i], args[2 * i + 1],
                                          comp_sig[i][0], comp_sig[i][1])
                     for i in range(n)), tuple(args[2 * n:3 * n])
    if int8_ks is not None:
        return tuple(coef_restore.int8_restore(*args[3 * i:3 * i + 3])
                     for i in range(n)), tuple(args[3 * n:4 * n])
    return tuple(args[:n]), tuple(args[n:2 * n])


def coef_graph(sig, args, consts: DeviceConstants,
               backend: Optional[str] = "device",
               byte_cap: Optional[int] = None, fused: bool = False,
               normalize: bool = False, **upload_ks):
    """One host-coefficient batch through the device stages: the restore
    (`restore_planes`), then the pixel and output stages of the scan
    path."""
    coefs, qtabs = restore_planes(sig, args, **upload_ks)
    px = pixel_stages(sig, coefs, qtabs, consts, fused, normalize)
    return output_stages(px, consts, backend, byte_cap, normalize)


def upload_args(args, device):
    """`stack_bucket`'s host arrays -> device tensors, each through pinned
    memory; the uint16 qtables as int32 (the pixel stages' type)."""
    return [upload(a.astype(np.int32) if a.dtype == np.uint16 else a, device)
            for a in args]


def stack_gap4_wire(cos, native: bool = False):
    """Same-signature coefficient sets -> (sig, gap4_ks, wire uint8): the
    reference's `stack_gap4_wire` (:183-215) at its defaults (no size
    floor, no headroom)."""
    sig = signature(cos[0])
    n = len(cos[0].comps)
    nb = len(cos)
    ks, sections = [], []
    for i in range(n):
        k1, k2, kc, prim, sgaps, svals, ci, cv = coef_host.gap4_pack_batch(
            [co.comps[i]["coefs"] for co in cos], native=native)
        sections += [prim.reshape(-1), sgaps.reshape(-1),
                     svals.view(np.uint8).reshape(-1),
                     ci.view(np.uint8).reshape(-1),
                     cv.view(np.uint8).reshape(-1)]
        ks.append((k1, k2, kc))
    for i in range(n):
        q = np.stack([co.comps[i]["qtable"] for co in cos])
        sections.append(np.ascontiguousarray(
            q.astype(np.uint16)).view(np.uint8).reshape(-1))
    return sig, (nb, tuple(ks)), np.concatenate(sections)


def stack_coefficients(cos, upload: str, native: bool = False):
    """The reference's `stack_bucket` (:600-714) for coefficient sets:
    (sig, args) for "dense", (sig, ks, args) for the others, the arrays
    the reference uploads, with its padding rules (sparse and int8 pad at
    index m - 1 with 0; gap8 corrections at nb * m - 1; gap4 with the
    no-op codes). `native`: the C++ packers in place of the numpy ones
    (the same bytes)."""
    sig = signature(cos[0])
    n = len(cos[0].comps)
    args = []

    def qtabs():
        return [np.stack([co.comps[i]["qtable"] for co in cos])[
            :, None, None, :] for i in range(n)]

    if upload == "sparse":
        ks = []
        for i in range(n):
            flats = [co.comps[i]["coefs"].reshape(-1) for co in cos]
            nzs = [np.flatnonzero(f) for f in flats]
            k = max(1, max(nz.size for nz in nzs))
            k = -(-k // 16384) * 16384
            m = flats[0].size
            idx = np.full((len(cos), k), m - 1, np.int32)
            val = np.zeros((len(cos), k), np.int16)
            for j, (f, nz) in enumerate(zip(flats, nzs)):
                idx[j, : nz.size] = nz
                val[j, : nz.size] = f[nz]
            args += [idx, val]
            ks.append(k)
        return sig, tuple(ks), args + qtabs()
    if upload == "gap4":
        sig, ks, wire = stack_gap4_wire(cos, native=native)
        return sig, ks, [wire]
    if upload == "gap8":
        nb = len(cos)
        ks, sections = [], []
        for i in range(n):
            m = cos[0].comps[i]["coefs"].size
            packed = [coef_host.gap8_pack(co.comps[i]["coefs"], native)
                      for co in cos]
            k = max(g.size for g, _, _, _ in packed)
            k = -(-k // 8192) * 8192
            gaps = np.zeros((nb, k), np.uint8)
            vals = np.zeros((nb, k), np.int8)
            ci_parts, cv_parts = [], []
            for j, (g, v, ci, cv) in enumerate(packed):
                gaps[j, : g.size] = g
                vals[j, : v.size] = v
                if ci.size:
                    ci_parts.append(ci.astype(np.int64) + j * m)
                    cv_parts.append(cv)
            nc = sum(p.size for p in ci_parts)
            kc = -(-max(1, nc) // 1024) * 1024
            corr_idx = np.full((kc,), nb * m - 1, np.int32)
            corr_val = np.zeros((kc,), np.int16)
            if nc:
                corr_idx[:nc] = np.concatenate(ci_parts)
                corr_val[:nc] = np.concatenate(cv_parts)
            sections += [gaps.reshape(-1), vals.view(np.uint8).reshape(-1),
                         corr_idx.view(np.uint8).reshape(-1),
                         corr_val.view(np.uint8).reshape(-1)]
            ks.append((k, kc))
        for i in range(n):
            q = np.stack([co.comps[i]["qtable"] for co in cos])
            sections.append(np.ascontiguousarray(
                q.astype(np.uint16)).view(np.uint8).reshape(-1))
        return sig, (nb, tuple(ks)), [np.concatenate(sections)]
    if upload == "int8":
        ks = []
        for i in range(n):
            c16 = np.stack([co.comps[i]["coefs"] for co in cos])
            c8 = np.clip(c16, -128, 127).astype(np.int8)
            resid = c16.astype(np.int32) - c8
            flat_idx = np.flatnonzero(resid)
            vals = resid.reshape(-1)[flat_idx].astype(np.int16)
            k = max(1, flat_idx.size)
            k = -(-k // 4096) * 4096
            m = resid.size
            idx = np.full((k,), m - 1, np.int32)
            val = np.zeros((k,), np.int16)
            idx[: flat_idx.size] = flat_idx
            val[: flat_idx.size] = vals
            args += [c8, idx, val]
            ks.append(k)
        return sig, tuple(ks), args + qtabs()
    for i in range(n):
        args.append(np.stack([co.comps[i]["coefs"] for co in cos]))
    return sig, args + qtabs()


def _not_ported(what: str):
    """The reference's libjpeg host paths and its streaming schedulers
    (`host_fast_scale`, `host_raw`, `host_draft`, `fast_guard`,
    `host_encode_batch*`, `stream*`) are ROADMAP queue 1 item 5."""
    raise NotImplementedError(
        f"JpegBatchPipeline: {what} is not ported yet (ROADMAP queue 1 "
        f"item 5)")


class JpegBatchPipeline:
    """decode -> (resize) -> {uint8 | normalized | re-encoded JPEG} over
    homogeneous-signature batches on one device (see module doc)."""

    def __init__(self, width: Optional[int] = None,
                 height: Optional[int] = None,
                 filter: Optional[str] = None,
                 filter_scale: Optional[float] = None,
                 normalize: bool = False,
                 encode_quality: Optional[int] = None,
                 encode_backend: str = "tpu",
                 upload: str = "dense",
                 fused: bool = False,
                 num_threads: Optional[int] = None,
                 scan_byte_cap: Optional[int] = None,
                 host_fast_scale: bool = False,
                 host_raw: bool = False,
                 host_draft: bool = False,
                 fast_guard: Optional[float] = None,
                 device="cuda"):
        host_opts = dict(host_fast_scale=host_fast_scale, host_raw=host_raw,
                         host_draft=host_draft)
        for name, value in host_opts.items():
            if value:
                _not_ported(f"{name}=True")
        if fast_guard is not None:
            _not_ported("fast_guard")
        if encode_backend not in ENCODE_BACKENDS:
            raise ValueError(f"encode_backend must be one of "
                             f"{ENCODE_BACKENDS}, got {encode_backend!r}")
        if upload not in UPLOADS:
            raise ValueError(f"upload must be one of {UPLOADS}, got "
                             f"{upload!r}")
        opts = {}
        if filter is not None:
            opts["filter"] = filter
        if filter_scale is not None:
            opts["filterScale"] = filter_scale
        self._filter, self._fscale = parse_resize_options(opts)
        self._width, self._height = width, height
        self._normalize = normalize
        self._fused = fused
        self._upload = upload
        self._num_threads = num_threads or 8
        self._pool = None
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

    # -- the reference's host and streaming paths, not ported -------------

    def host_encode_batch(self, bufs):
        _not_ported("host_encode_batch")

    def host_encode_batch_staged(self, bufs, stats, q):
        _not_ported("host_encode_batch_staged")

    def stream_hybrid(self, batches, depth: int = 2):
        _not_ported("stream_hybrid")

    def stream_host(self, batches):
        _not_ported("stream_host")

    def stream(self, batches, depth: int = 2):
        _not_ported("stream")

    def close(self):
        """Release the host thread pool, and the overflow clone's
        (idempotent); the pipeline stays usable and starts a new pool when
        it needs one."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._overflow_clone is not None:
            self._overflow_clone.close()

    # -- host stage ----------------------------------------------------------

    def _native(self) -> bool:
        """The host C++ decoder, packers and JPEG writer serve a CUDA
        device; the CPU takes their numpy plain versions."""
        return self.device.type == "cuda"

    def _host_pool(self):
        """The pool of `num_threads` host threads that runs the host C++
        (which releases the GIL) for a CUDA device; None for the CPU,
        whose plain versions run serially."""
        if self._native() and self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_threads,
                thread_name_prefix="picha-entropy")
        return self._pool

    def _map(self, fn, seq):
        pool = self._host_pool()
        if pool is None:
            return [fn(x) for x in seq]
        return list(pool.map(fn, seq))

    def entropy_decode(self, bufs):
        """upload="scan": parsed headers (the device decodes the scans);
        the other uploads: coefficient sets decoded on the host (the C++
        decoder on `num_threads` pool threads, or its numpy plain version
        on the CPU). When a file is one the decoder does not take
        (progressive, arithmetic, CMYK; for "scan" also too many table
        rows or an oversized batch), the whole batch is decoded to pixels
        on the host (counted)."""
        infos = [parse_baseline(bytes(b)) for b in bufs]
        if self._upload != "scan" and all(i is not None for i in infos):
            return coef_host.entropy_decode(infos, self._native(),
                                            self._host_pool(),
                                            self._num_threads)
        if self._upload == "scan" and all(i is not None for i in infos):
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
                   if self._encode_backend in ("device", "tpu") else None)
        key = (sig, quality)
        if key not in self._consts:
            self._consts[key] = device_constants(
                sig, self._width, self._height, self._filter, self._fscale,
                quality, self.device, fused=self._fused)
        return self._consts[key]

    def _backend(self) -> Optional[str]:
        """The encode backend of the device stages: None when the batch
        is not encoded (no quality, or normalize)."""
        if self._encode_quality is None or self._normalize:
            return None
        return self._encode_backend

    def _cap(self, sig) -> Optional[int]:
        return (self._scan_cap_for(sig) if self._backend() == "device"
                else None)

    def stack_bucket(self, cos):
        """Same-signature coefficient sets -> the upload's host arrays, as
        the reference's `stack_bucket`: (sig, args) for "dense", (sig, ks,
        args) for the other uploads (see `stack_coefficients`)."""
        return stack_coefficients(cos, self._upload, self._native())

    def run_bucket(self, sig, args, scan_ks=None, **upload_ks):
        """One uploaded batch -> its device output: a scan batch's wire
        (`scan_ks`) -> (output, ok) (see device_graph); a
        host-coefficient batch's arguments (`sparse_ks`, `int8_ks`,
        `gap8_ks` or `gap4_ks`, none for "dense") -> the output (see
        coef_graph)."""
        backend, cap = self._backend(), self._cap(sig)
        if scan_ks is not None:
            return device_graph(sig, args, self.constants(sig), scan_ks,
                                backend=backend, byte_cap=cap,
                                fused=self._fused, normalize=self._normalize)
        return coef_graph(sig, args, self.constants(sig), backend=backend,
                          byte_cap=cap, fused=self._fused,
                          normalize=self._normalize, **upload_ks)

    def run_pixels(self, sig, rgb):
        """Uploaded host-decoded uint8 images of one batch -> the device
        output (the resize, then as `output_stages`)."""
        consts = self.constants(sig)
        px = resized_pixels(rgb, consts.windows, self._normalize)
        return output_stages(px, consts, self._backend(), self._cap(sig),
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
        with `encode_backend="raw420"` (the device pixel stages, then the
        host writer, which has no budget), as the reference's :806-829:
        the clone's upload is this one's, "gap4" in place of "scan", and
        a scan batch is decoded on the host first."""
        self.overflow_fallbacks += 1
        if self._overflow_clone is None:
            self._overflow_clone = JpegBatchPipeline(
                width=self._width, height=self._height, filter=self._filter,
                filter_scale=self._fscale,
                encode_quality=self._encode_quality, encode_backend="raw420",
                fused=self._fused,
                upload=self._upload if self._upload != "scan" else "gap4",
                num_threads=self._num_threads, device=self.device)
        clone = self._overflow_clone
        if isinstance(cos[0], ScanInfo):
            cos = coef_host.entropy_decode(cos, clone._native(),
                                           clone._host_pool(),
                                           clone._num_threads)
        return clone._finish(*clone._process(cos))

    def _process(self, cos):
        """Homogeneous batch -> (sig, device output)."""
        if isinstance(cos[0], HostPixels):
            sig = signature(cos[0])
            rgb = upload(np.stack([c.pixels for c in cos]), self.device)
            return sig, self.run_pixels(sig, rgb)
        if not isinstance(cos[0], ScanInfo):
            # host coefficients: the upload's wire, then its restore
            packed = self.stack_bucket(cos)
            if self._upload == "dense":
                (sig, args), upload_ks = packed, {}
            else:
                sig, ks, args = packed
                upload_ks = {self._upload + "_ks": ks}
            return sig, self.run_bucket(sig, upload_args(args, self.device),
                                        **upload_ks)
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
        backend = self._backend()
        if backend is None:
            return out
        if backend == "host":
            q = self._encode_quality
            return [jpeg_host.encode(img, q) for img in out.cpu().numpy()]
        if backend == "raw420":
            return self.raw420_encode(out, sig)
        if backend == "tpu":
            return self.huffman_encode(out, sig)
        return self.scan_finish(out, sig)

    def _scan_fallback(self, bufs):
        """The device decoder flagged the batch (malformed stream, or no
        fixpoint within the pass budget): host pixel decode, then the
        device stages that follow a decode."""
        self.scan_fallbacks += 1
        return self._finish(*self._process(host_decode(bufs)))

    def _encode_size(self, sig):
        return (self._width if self._width is not None else sig[0],
                self._height if self._height is not None else sig[1])

    def raw420_encode(self, planes, sig):
        """Host stage of "raw420" (the reference's :1263-1282): one
        readback of K31's (N, bytes) buffer, then the host writer per
        image on the pool."""
        ew, eh = self._encode_size(sig)
        buf = planes.cpu().numpy()
        q, native = self._encode_quality, self._native()

        def enc(i):
            return jpeg_write.write_raw420(
                *jpeg_write.split_yuv420(buf[i], ew, eh), ew, eh, q,
                native=native)
        return self._map(enc, range(buf.shape[0]))

    def huffman_encode(self, coefs, sig):
        """Host stage of "tpu" (the reference's :1284-1306): K2's int16
        planes read back, then the host writer per image on the pool."""
        ew, eh = self._encode_size(sig)
        outs = [c.cpu().numpy() for c in coefs]
        q, native = self._encode_quality, self._native()

        def enc(i):
            return jpeg_write.write_coefficients([o[i] for o in outs], ew,
                                                 eh, q, native=native)
        return self._map(enc, range(outs[0].shape[0]))

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
                "encode_backend='tpu' / 'raw420' / 'host'")
        m = min(cap, -(-int(nb.max()) // 65536) * 65536)
        host = scan[:, :m].cpu().numpy()
        ew, eh = self._encode_size(sig)
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
