"""JPEG pixel stages on the device: the staged decode (quantised DCT
coefficients -> RGB/grey bytes) and the encoder front (RGB float image
-> quantised DCT coefficients).

Counterpart of `picha_tpu/ops/jpeg_tpu.py`. Decode half:
`dequant_idct_plane`, `fancy_upsample_h/v/h2v2`, `upsample_to`,
`ycbcr_to_rgb_int`, `cmyk_fold_to_rgb`, `ycck_to_cmyk` and
`build_decode_stage`, with the reference's names and libjpeg(-turbo)
integer semantics. Encode half: `rgb_to_ycbcr`, `box_downsample_2x2`,
`plane_to_blocks`, `fdct_quant`, `_jit_encode`, plus the u8 pack the
reference pipeline applies first (`picha_tpu/pipeline/jpeg_batch.py`,
floor(clip(v + 0.5))).

Kernel wrappers, each running its plain torch twin for CPU tensors and
launching its kernel for CUDA tensors (or raising):
  `dequant_idct_plane`  K6 `csrc/jpeg_idct_plane.cu`
  `upsample_color`      K7 `csrc/jpeg_upsample_color.cu`
  `encode_blocks`       K2 `csrc/jpeg_encode_front.cu`
  `yuv420_pack`         K31 `csrc/yuv420_pack.cu` (the raw420 encode's
                        4:2:0 planes)
The quantisation tables (`quality_tables`) and the 64x64 Kronecker DCT
(`_idct_kron`) are numpy constants (the port's copies of the
reference's, pinned by `tests/test_torch_host_copies.py`), uploaded once
per configuration by the caller. `full_fp32` keeps every float32 matmul
of the port in IEEE float32.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from ..errors import CodecError
from ..kernels._build import KERNELS, aligned, ptr, require_cuda, stream_of

# JPEG colour spaces (libjpeg J_COLOR_SPACE numbering)
CS_GRAYSCALE, CS_RGB, CS_YCBCR, CS_CMYK, CS_YCCK = 1, 2, 3, 4, 5


def FIX(x):
    """libjpeg's 16-bit fixed-point constant."""
    return int(x * 65536 + 0.5)


_ONE_HALF = 32768


def idct_matrix() -> np.ndarray:
    """A[u, x] = C(u)/2 * cos((2x+1) u pi / 16); IDCT: P = A^T B A."""
    A = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        cu = math.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            A[u, x] = 0.5 * cu * math.cos((2 * x + 1) * u * math.pi / 16)
    return A.astype(np.float32)


_IDCT_A = idct_matrix()


@functools.lru_cache(maxsize=1)
def _idct_kron() -> np.ndarray:
    """(64, 64) Kronecker IDCT: pixel_flat = coef_flat @ M with
    M[(v,u),(y,x)] = A[v,y] * A[u,x]."""
    a = _IDCT_A.astype(np.float64)
    m = np.einsum("vy,ux->vuyx", a, a).reshape(64, 64)
    return m.astype(np.float32)


def check_integer_sampling(comp_sig):
    """Raise CodecError for fractional upsampling ratios, as libjpeg's
    pixel path does ('fractional sampling not implemented')."""
    max_h = max(s[2] for s in comp_sig)
    max_v = max(s[3] for s in comp_sig)
    for _, _, hs, vs in comp_sig:
        if max_h % hs or max_v % vs:
            raise CodecError("fractional sampling not implemented")


def _plane_geometry(width, height, h_samp, v_samp, max_h, max_v):
    """(dw, dh): a component's cropped plane at its sampling."""
    return (math.ceil(width * h_samp / max_h),
            math.ceil(height * v_samp / max_v))


# IJG standard base tables (natural order), jcparam.c
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int32)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.int32)


def quality_tables(quality: int):
    """jpeg_set_quality / jpeg_quality_scaling (jcparam.c) with
    force_baseline: (luma, chroma) (64,) uint16, natural order."""
    quality = min(100, max(1, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2

    def scale_tab(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.uint16)

    return scale_tab(_STD_LUMA_Q), scale_tab(_STD_CHROMA_Q)


_FP32_BACKENDS = (torch.backends.cuda.matmul, torch.backends.cudnn.conv,
                  torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def full_fp32():
    """IEEE float32 matmuls and convolutions (cuBLAS, cuDNN, oneDNN)
    inside the block, whatever `torch.set_float32_matmul_precision` or
    the `allow_tf32` flags say outside; the previous per-backend
    settings are restored exactly. (Only the per-backend
    `fp32_precision` API is touched: writing the legacy flags back after
    a global precision change leaves torch in a "mixed" state whose
    legacy getter raises.)"""
    prev = [b.fp32_precision for b in _FP32_BACKENDS]
    for b in _FP32_BACKENDS:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, p in zip(_FP32_BACKENDS, prev):
            b.fp32_precision = p


@contextlib.contextmanager
def full_precision():
    """`full_fp32`, and bf16 products summed in float32 inside the block.
    torch lets cuBLAS reduce a bf16 product's partial sums in bf16 by
    default (`allow_bf16_reduced_precision_reduction` is True); the
    reference (XLA) sums them in f32, so this pins the flag to False and
    restores the caller's setting (with its split-K part, where the
    installed torch has one) afterwards."""
    m = torch.backends.cuda.matmul
    prev = m.allow_bf16_reduced_precision_reduction
    split_k = getattr(m, "allow_bf16_reduced_precision_reduction_split_k",
                      None)
    m.allow_bf16_reduced_precision_reduction = False
    try:
        with full_fp32():
            yield
    finally:
        m.allow_bf16_reduced_precision_reduction = (
            prev if split_k is None else (prev, split_k))


def pack_u8(f255):
    """The pipeline's pack rule floor(clip(v + 0.5, 0, 255)) -> uint8."""
    return torch.floor((f255 + 0.5).clamp(0.0, 255.0)).to(torch.uint8)


def _cdiv(a, b):
    return -(-a // b)


def rgb_to_ycbcr(rgb):
    """libjpeg jccolor.c forward transform (int32 fixed point)."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    y = (FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b
         + _ONE_HALF) >> 16
    cb = ((-FIX(0.16874)) * r + (-FIX(0.33126)) * g + FIX(0.50000) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    cr = (FIX(0.50000) * r + (-FIX(0.41869)) * g + (-FIX(0.08131)) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    return y, cb, cr


def _edge_pad(plane, h2, w2):
    """Pad the last two dims to (h2, w2) by edge replication."""
    h, w = plane.shape[-2], plane.shape[-1]
    rows = torch.arange(h2, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(w2, device=plane.device).clamp(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def box_downsample_2x2(plane):
    """2x2 average with (+2) >> 2 rounding, odd dims edge-padded."""
    h, w = plane.shape[-2], plane.shape[-1]
    p = _edge_pad(plane, h + h % 2, w + w % 2)
    p = p.reshape(p.shape[:-2] + ((h + 1) // 2, 2, (w + 1) // 2, 2))
    return (p.sum(dim=(-3, -1)) + 2) >> 2


def plane_to_blocks(plane, bh, bw):
    """(..., h, w) -> (..., bh, bw, 64), edge-padding to whole blocks."""
    p = _edge_pad(plane, bh * 8, bw * 8)
    p = p.reshape(p.shape[:-2] + (bh, 8, bw, 8)).transpose(-3, -2)
    return p.reshape(p.shape[:-2] + (64,))


def fdct_quant(blocks, qtable, kron):
    """(..., 64) int samples -> quantised int16 coefficients: Kronecker
    fDCT in float32, divide by the table, round half to even."""
    b = blocks.to(torch.float32) - 128.0
    with full_fp32():
        f = torch.matmul(b, kron.t())
    return torch.round(f / qtable.to(torch.float32)).to(torch.int16)


def front_samples(f255):
    """f255 (N, H, W, C) float32 (C 1 or 3) -> per-component (N, bh,
    bw, 64) int32 sample blocks: pack, colour convert, 4:2:0 chroma
    downsample, pad."""
    height, width, ncomp = f255.shape[1], f255.shape[2], f255.shape[3]
    img = pack_u8(f255).to(torch.int32)
    ybh, ybw = _cdiv(height, 8), _cdiv(width, 8)
    if ncomp == 1:
        return (plane_to_blocks(img[..., 0], ybh, ybw),)
    y, cb, cr = rgb_to_ycbcr(img)
    cb, cr = box_downsample_2x2(cb), box_downsample_2x2(cr)
    cbh, cbw = _cdiv(cb.shape[-2], 8), _cdiv(cb.shape[-1], 8)
    return (plane_to_blocks(y, ybh, ybw), plane_to_blocks(cb, cbh, cbw),
            plane_to_blocks(cr, cbh, cbw))


def yuv420_sizes(h: int, w: int):
    """(hpad, wpad, Y bytes, Cb bytes) of the 4:2:0 planes `yuv420_pack`
    writes for an h x w image: Y edge-padded to 16-multiples, Cb and Cr
    half that."""
    hpad, wpad = (h + 15) & ~15, (w + 15) & ~15
    return hpad, wpad, hpad * wpad, (hpad // 2) * (wpad // 2)


def yuv420_pack_plain(px):
    """Plain torch version of K31, the reference's `yuv420_out` branch
    (`picha_tpu/pipeline/jpeg_batch.py:384-413`): px (N, H, W, C) float32
    on the 0-255 scale (packed floor(clip(v + 0.5))) or uint8 (taken as
    they are), C 1 or 3 -> (N, Y + 2 Cb bytes) uint8, the padded Y plane,
    then Cb, then Cr. Colour: jccolor's fixed point, each plane
    edge-padded to (ceil16(H), ceil16(W)) before the 2x2 box downsample
    of Cb and Cr; grey: Y and constant 128 chroma planes (the host writer
    always writes three components)."""
    n, h, w, c = px.shape
    hpad, wpad, _, _ = yuv420_sizes(h, w)
    img = (px if px.dtype == torch.uint8 else pack_u8(px)).to(torch.int32)
    if c == 1:
        y = _edge_pad(img[..., 0], hpad, wpad)
        cb = cr = torch.full((n, hpad // 2, wpad // 2), 128,
                             dtype=torch.int32, device=px.device)
    else:
        y, cb, cr = (_edge_pad(p, hpad, wpad) for p in rgb_to_ycbcr(img))
        cb, cr = box_downsample_2x2(cb), box_downsample_2x2(cr)
    return torch.cat([p.to(torch.uint8).reshape(n, -1) for p in (y, cb, cr)],
                     1)


def yuv420_pack(px):
    """The 4:2:0 planes of the raw420 encode (see `yuv420_pack_plain`) in
    one buffer per image. Launches K31 (`csrc/yuv420_pack.cu`) for CUDA
    tensors; the plain version runs only for CPU tensors."""
    if px.device.type == "cpu":
        return yuv420_pack_plain(px)
    require_cuda(px, "K31")
    if px.dtype not in (torch.float32, torch.uint8) or px.dim() != 4 \
            or px.shape[3] not in (1, 3):
        raise TypeError("K31 takes a (N, H, W, 1|3) float32 or uint8 image")
    px = px.contiguous()
    n, h, w, c = px.shape
    _, _, ysz, csz = yuv420_sizes(h, w)
    out = torch.empty((n, ysz + 2 * csz), dtype=torch.uint8, device=px.device)
    KERNELS["yuv420_pack"](ptr(px), int(px.dtype == torch.uint8), n, h, w, c,
                           ptr(out), stream_of(px))
    return out


def encode_blocks_plain(f255, qluma, qchroma, kron):
    """Plain torch version of K2. f255 (N, H, W, C) float32 (C 1 or 3)
    -> tuple of (N, bh, bw, 64) int16 per component."""
    return tuple(fdct_quant(b, qluma if i == 0 else qchroma, kron)
                 for i, b in enumerate(front_samples(f255)))


def encode_blocks(f255, qluma, qchroma, kron):
    """f255 (N, H, W, C) float32 -> quantised coefficient planes (4:2:0
    for colour, as the reference pipeline encodes). qluma /
    qchroma (64,) int32 natural order, kron the (64, 64) float32
    Kronecker DCT, all on f255's device. Launches K2 for CUDA tensors;
    the plain version runs only for CPU tensors."""
    if f255.device.type == "cpu":
        return encode_blocks_plain(f255, qluma, qchroma, kron)
    require_cuda(f255, "K2")
    dev = f255.device
    if f255.dtype != torch.float32 or f255.dim() != 4 \
            or f255.shape[3] not in (1, 3):
        raise TypeError("K2 takes a (N, H, W, 1|3) float32 image")
    for t, dt in ((qluma, torch.int32), (qchroma, torch.int32),
                  (kron, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError("K2 tables must be contiguous int32 qtables "
                            "and a float32 kron on the image's device")
    kron = aligned(kron)
    f255 = f255.contiguous()
    n, h, w, c = f255.shape
    ybh, ybw = _cdiv(h, 8), _cdiv(w, 8)
    cbh, cbw = _cdiv(_cdiv(h, 2), 8), _cdiv(_cdiv(w, 2), 8)
    out_y = torch.empty((n, ybh, ybw, 64), dtype=torch.int16, device=dev)
    if c == 3:
        out_cb = torch.empty((n, cbh, cbw, 64), dtype=torch.int16,
                             device=dev)
        out_cr = torch.empty_like(out_cb)
    else:
        out_cb = out_cr = out_y
    KERNELS["jpeg_encode_front"](
        ptr(f255), n, h, w, c, ptr(qluma), ptr(qchroma),
        ptr(kron), ptr(out_y), ptr(out_cb), ptr(out_cr), ybh, ybw, cbh,
        cbw, stream_of(f255))
    return (out_y,) if c == 1 else (out_y, out_cb, out_cr)


_K2_INFO_KEYS = ("registers", "local_bytes", "static_shared_bytes",
                 "dynamic_shared_bytes", "blocks_an_sm", "sms", "threads",
                 "mcus_a_tile")


def encode_kernel_info(f255) -> dict:
    """K2's build and launch plan for the (N, H, W, C) CUDA image
    `f255`: registers, local bytes a thread, static and dynamic shared
    bytes, blocks an SM, SMs, threads a block, MCUs a tile (8x8 blocks
    for grey), tiles and the grid the launch uses."""
    from ..kernels._build import library

    n, h, w, c = f255.shape
    out = (ctypes.c_int * len(_K2_INFO_KEYS))()
    with torch.cuda.device(f255.device):
        rc = library().picha_jpeg_encode_front_info(c, out)
    if rc != 0:
        raise RuntimeError(f"picha_jpeg_encode_front_info: CUDA error {rc}")
    info = dict(zip(_K2_INFO_KEYS, out))
    side = 16 if c == 3 else 8
    tiles = _cdiv(n * _cdiv(h, side) * _cdiv(w, side), info["mcus_a_tile"])
    return dict(info, tiles=tiles,
                grid=min(tiles, info["sms"] * info["blocks_an_sm"]))


# -- staged decode ----------------------------------------------------------

def idct_samples(coefs, qtable, kron):
    """(N, bh, bw, 64) int coefficients x (N, 1, 1, 64) qtables -> the
    (N, bh*8, bw*8) float32 samples before rounding: dequantise in f32,
    Kronecker IDCT as one full-f32 matmul, blocks -> raster, +128."""
    n, bh, bw = coefs.shape[0], coefs.shape[1], coefs.shape[2]
    f = coefs.to(torch.float32) * qtable.to(torch.float32)
    with full_fp32():
        pix = torch.matmul(f, kron)
    pix = pix.view(n, bh, bw, 8, 8).transpose(2, 3)
    return pix.reshape(n, bh * 8, bw * 8) + 128.0


def dequant_idct_plane_plain(coefs, qtable, kron, out_h, out_w):
    """Plain torch version of K6: -> (N, out_h, out_w) uint8, rounded
    half to even and clipped to [0, 255] like the reference's
    `jnp.round`."""
    plane = torch.round(idct_samples(coefs, qtable, kron)).clamp(0, 255)
    return plane[:, :out_h, :out_w].to(torch.uint8)


def dequant_idct_plane(coefs, qtable, kron, out_h, out_w):
    """Dequantise + IDCT one component: coefs (N, bh, bw, 64) int16 or
    int32, qtable (N, 1, 1, 64) int32 (one table per image), kron the
    (64, 64) float32 `_idct_kron()` -> (N, out_h, out_w) uint8 samples.
    Launches K6 for CUDA tensors; the plain version runs only for CPU
    tensors."""
    if coefs.device.type == "cpu":
        return dequant_idct_plane_plain(coefs, qtable, kron, out_h, out_w)
    require_cuda(coefs, "K6")
    dev = coefs.device
    if coefs.dtype not in (torch.int16, torch.int32) or coefs.dim() != 4 \
            or coefs.shape[3] != 64:
        raise TypeError("K6 takes (N, bh, bw, 64) int16 or int32 blocks")
    n, bh, bw = coefs.shape[0], coefs.shape[1], coefs.shape[2]
    if not 0 < out_h <= bh * 8 or not 0 < out_w <= bw * 8:
        raise ValueError(f"K6 crop ({out_h}, {out_w}) outside the "
                         f"{bh * 8}x{bw * 8} block grid")
    if qtable.dtype != torch.int32 or qtable.device != dev \
            or qtable.numel() != n * 64:
        raise TypeError("K6 takes (N, 1, 1, 64) int32 qtables on the "
                        "coefficients' device")
    if kron.dtype != torch.float32 or kron.device != dev \
            or tuple(kron.shape) != (64, 64):
        raise TypeError("K6 takes the (64, 64) float32 Kronecker IDCT on "
                        "the coefficients' device")
    coefs = aligned(coefs)
    qtable, kron = qtable.contiguous(), kron.contiguous()
    out = torch.empty((n, out_h, out_w), dtype=torch.uint8, device=dev)
    KERNELS["idct_plane"](ptr(coefs), coefs.element_size(), ptr(qtable),
                          ptr(kron), n, bh, bw, out_h, out_w, ptr(out),
                          stream_of(coefs))
    return out


def kernel_info() -> dict:
    """K6's builds (int32 and int16 coefficients) and K7's (`K7_BUILDS`)
    as the card reports them: registers and local (spill) bytes a
    thread, static shared bytes a block, resident blocks a
    multiprocessor, threads a block (K6 also its tile buffers in flight
    and dynamic shared bytes a block). Launches nothing."""
    import ctypes

    from ..kernels._build import library

    out = {}
    for name, width in (("int32", 4), ("int16", 2)):
        vals = (ctypes.c_int * 7)()
        rc = library().picha_idct_plane_info(width, vals)
        if rc != 0:
            raise RuntimeError(f"picha_idct_plane_info: CUDA error {rc}")
        out[f"K6_{name}"] = dict(zip(
            ("registers", "local_bytes", "static_shared_bytes",
             "blocks_per_sm", "threads", "stages", "dynamic_shared_bytes"),
            vals))
    for i, name in enumerate(K7_BUILDS):
        vals = (ctypes.c_int * 5)()
        rc = library().picha_upsample_color_info(i, vals)
        if rc != 0:
            raise RuntimeError(f"picha_upsample_color_info: CUDA error {rc}")
        out[f"K7_{name}"] = dict(zip(
            ("registers", "local_bytes", "static_shared_bytes",
             "blocks_per_sm", "threads"), vals))
    return out


def _shift(s, axis, step):
    """s shifted by one along `axis` with edge replication: step -1 gives
    each sample's predecessor, +1 its successor."""
    L = s.shape[axis]
    idx = torch.arange(L, device=s.device) + step
    return s.index_select(axis, idx.clamp(0, L - 1))


def _interleave(a, b, axis):
    """Stack a and b along a new axis after `axis` and merge: a, b, a,
    b, ... (axis is -1 or -2)."""
    out = torch.stack([a, b], dim=axis)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def fancy_upsample_h(plane):
    """Horizontal 2x fancy upsample, libjpeg h2v1 semantics (int32)."""
    s = plane
    even = (3 * s + _shift(s, -1, -1) + 1) >> 2
    odd = (3 * s + _shift(s, -1, 1) + 2) >> 2
    return _interleave(even, odd, -1)


def fancy_upsample_v(plane):
    """Vertical 2x: colsum stage of libjpeg h2v2 (returns 4x-scaled
    sums)."""
    s = plane
    return _interleave(3 * s + _shift(s, -2, -1), 3 * s + _shift(s, -2, 1),
                       -2)


def fancy_upsample_h2v2(plane):
    """Full 2x2 fancy upsample (libjpeg h2v2_fancy_upsample, exact)."""
    s = fancy_upsample_v(plane)
    even = (3 * s + _shift(s, -1, -1) + 8) >> 4
    odd = (3 * s + _shift(s, -1, 1) + 7) >> 4
    return _interleave(even, odd, -1)


def upsample_to(plane, h_factor, v_factor, out_h, out_w):
    """Upsample an int32 chroma plane by the component's sampling ratio
    and crop to the luma grid: libjpeg's fancy (triangle) kernels for
    2x2 and 2x1, libjpeg-turbo's h1v2 fancy kernel (per-parity biases
    +1 above, +2 below) for 1x2, and int_upsample replication for any
    other integer ratio."""
    if (h_factor, v_factor) == (2, 2):
        plane = fancy_upsample_h2v2(plane)
    elif (h_factor, v_factor) == (2, 1):
        plane = fancy_upsample_h(plane)
    elif (h_factor, v_factor) == (1, 2):
        s = plane
        up = (3 * s + _shift(s, -2, -1) + 1) >> 2
        down = (3 * s + _shift(s, -2, 1) + 2) >> 2
        plane = _interleave(up, down, -2)
    else:
        if h_factor > 1:
            plane = plane.repeat_interleave(h_factor, dim=-1)
        if v_factor > 1:
            plane = plane.repeat_interleave(v_factor, dim=-2)
    return plane[..., :out_h, :out_w]


def ycbcr_to_rgb_int(y, cb, cr):
    """libjpeg jdcolor.c fixed-point YCbCr->RGB (int32 in, [0, 255] out;
    `>>` on int32 is an arithmetic shift, a floor)."""
    cbs, crs = cb - 128, cr - 128
    r = y + ((FIX(1.40200) * crs + _ONE_HALF) >> 16)
    b = y + ((FIX(1.77200) * cbs + _ONE_HALF) >> 16)
    g = y + (((-FIX(0.34414)) * cbs + (-FIX(0.71414)) * crs + _ONE_HALF)
             >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255)


def cmyk_fold_to_rgb(c, m, y_, k):
    """The reference's Adobe-inverted-CMYK fold rgb = c*k // 255."""
    return torch.div(torch.stack([c, m, y_], dim=-1) * k[..., None], 255,
                     rounding_mode="floor")


def ycck_to_cmyk(y, cb, cr, k):
    """libjpeg ycck_cmyk_convert: invert the YCC->RGB result, K passes."""
    cmy = 255 - ycbcr_to_rgb_int(y, cb, cr)
    return cmy[..., 0], cmy[..., 1], cmy[..., 2], k


def plane_geometry(comp_sig, width, height):
    """Per component (dh, dw, h_factor, v_factor): the cropped plane K6
    writes and its upsampling ratio to the luma grid."""
    max_h = max(s[2] for s in comp_sig)
    max_v = max(s[3] for s in comp_sig)
    out = []
    for _bh, _bw, hs, vs in comp_sig:
        dw, dh = _plane_geometry(width, height, hs, vs, max_h, max_v)
        out.append((dh, dw, max_h // hs, max_v // vs))
    return out


# K7's colour modes and builds (csrc/jpeg_upsample_color.cu): YCbCr
# h2v2 (4:2:0), h2v1 (4:2:2), h1v1 (4:4:4) and grey to 1 or 3 channels
# compiled in, a thread a pixel for every other signature
GREY, YCBCR, RGB, YCCK, CMYK = 0, 1, 2, 3, 4
K7_BUILDS = ("h2v2", "h2v1", "h1v1", "grey", "grey_rgb", "generic")
# the compiled-in builds' signatures: build -> (per-component (h_samp,
# v_samp), colour space, force_rgb)
K7_SIGNATURES = {
    "h2v2": (((2, 2), (1, 1), (1, 1)), CS_YCBCR, False),
    "h2v1": (((2, 1), (1, 1), (1, 1)), CS_YCBCR, False),
    "h1v1": (((1, 1),) * 3, CS_YCBCR, False),
    "grey": (((1, 1),), CS_GRAYSCALE, False),
    "grey_rgb": (((1, 1),), CS_GRAYSCALE, True),
}


def comp_sig_of(samp, width, height):
    """The comp_sig (block rows, block columns, h_samp, v_samp a
    component) of a width x height image whose components have these
    (h_samp, v_samp): whole MCUs, as a JPEG codes them."""
    max_h = max(h for h, _ in samp)
    max_v = max(v for _, v in samp)
    return tuple((-(-height // (8 * max_v)) * v, -(-width // (8 * max_h)) * h,
                  h, v) for h, v in samp)


def color_mode(color_space, ncomp):
    """The reference's colour dispatch -> a K7 mode: one component is
    grey whatever the colour space says."""
    if color_space == CS_GRAYSCALE or ncomp == 1:
        return GREY
    modes = {CS_YCBCR: YCBCR, CS_RGB: RGB, CS_YCCK: YCCK, CS_CMYK: CMYK}
    if color_space not in modes:
        raise ValueError(f"unsupported jpeg colour space {color_space}")
    return modes[color_space]


def upsample_color_plain(planes, comp_sig, color_space, width, height,
                         force_rgb=False):
    """Plain torch version of K7: uint8 planes (N, dh, dw) -> (N, height,
    width, C) uint8 (C = 1 for grey unless force_rgb, else 3)."""
    mode = color_mode(color_space, len(planes))
    up = []
    for p, (_dh, _dw, fx, fy) in zip(planes,
                                     plane_geometry(comp_sig, width, height)):
        p = p.to(torch.int32)
        if (fx, fy) != (1, 1):
            p = upsample_to(p, fx, fy, height, width)
        up.append(p[..., :height, :width])
    if mode == GREY:
        g = up[0][..., None]
        out = g.expand(*g.shape[:-1], 3) if force_rgb else g
    elif mode == YCBCR:
        out = ycbcr_to_rgb_int(*up[:3])
    elif mode == RGB:
        out = torch.stack(up[:3], dim=-1)
    elif mode == YCCK:
        out = cmyk_fold_to_rgb(*ycck_to_cmyk(*up[:4]))
    else:
        out = cmyk_fold_to_rgb(*up[:4])
    return out.to(torch.uint8)


def k7_build(comp_sig, color_space, width, height, force_rgb=False) -> str:
    """The K7 build (`K7_BUILDS`) that `upsample_color` launches for this
    signature, as the kernel library picks it."""
    from ..kernels._build import library

    mode = color_mode(color_space, len(comp_sig))
    geom = plane_geometry(comp_sig, width, height)
    used = 1 if mode == GREY else (4 if mode in (YCCK, CMYK) else 3)
    ratios = [r for i in range(4) for r in geom[min(i, used - 1)][2:]]
    c = 3 if mode != GREY or force_rgb else 1
    return K7_BUILDS[library().picha_upsample_color_build(*ratios, mode, c)]


def upsample_color(planes, comp_sig, color_space, width, height,
                   force_rgb=False):
    """Chroma upsample + colour transform: per-component uint8 planes
    (N, dh, dw) as `dequant_idct_plane` crops them (contiguous, at any
    byte offset) -> (N, height, width, C) uint8. Launches K7 for CUDA
    tensors; the plain version runs only for CPU tensors."""
    if planes[0].device.type == "cpu":
        return upsample_color_plain(planes, comp_sig, color_space, width,
                                    height, force_rgb)
    require_cuda(planes[0], "K7")
    mode = color_mode(color_space, len(planes))
    geom = plane_geometry(comp_sig, width, height)
    used = 1 if mode == GREY else (4 if mode in (YCCK, CMYK) else 3)
    if len(planes) < used or len(planes) > 4:
        raise ValueError(f"K7: {len(planes)} planes for colour space "
                         f"{color_space}")
    n, dev = planes[0].shape[0], planes[0].device
    for p, (dh, dw, _fx, _fy) in zip(planes, geom):
        if p.dtype != torch.uint8 or p.device != dev \
                or tuple(p.shape) != (n, dh, dw) or not p.is_contiguous():
            raise TypeError(f"K7 takes contiguous (N, {dh}, {dw}) uint8 "
                            f"planes on one device")
    c = 3 if mode != GREY or force_rgb else 1
    out = torch.empty((n, height, width, c), dtype=torch.uint8, device=dev)
    ptrs, dims = [], []
    for i in range(4):
        j = min(i, used - 1)
        ptrs.append(ptr(planes[j]))
        dims.extend(geom[j])
    KERNELS["upsample_color"](*ptrs, *dims, n, height, width, mode, c,
                              ptr(out), stream_of(out))
    return out


def build_decode_stage(comp_sig, color_space, width, height,
                       force_rgb: bool = False):
    """The staged decode for one signature: `stage(coefs, qtabs, kron)`
    -> (N, height, width, C) uint8, C = 1 (grey) or 3. Per component
    dequant + IDCT cropped to its plane (K6), then chroma upsample and
    colour transform (K7). `comp_sig` entries are (bh, bw, h_samp,
    v_samp); coefs per component (N, bh, bw, 64) int16/int32, qtabs
    (N, 1, 1, 64) int32, kron the (64, 64) float32 `_idct_kron()`."""
    check_integer_sampling(comp_sig)
    geom = plane_geometry(comp_sig, width, height)
    color_mode(color_space, len(comp_sig))

    def decode_stage(coefs, qtabs, kron):
        planes = [dequant_idct_plane(coefs[i], qtabs[i], kron, dh, dw)
                  for i, (dh, dw, _fx, _fy) in enumerate(geom)]
        return upsample_color(planes, comp_sig, color_space, width, height,
                              force_rgb)

    return decode_stage
