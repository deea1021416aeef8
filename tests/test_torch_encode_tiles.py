"""The tiled designs of K2 (the JPEG encoder front,
csrc/jpeg_encode_front.cu) and K3 (the scan encode,
csrc/huffman_encode_scan.cu) as numpy models of their phases
(`torch_helpers.k2_samples_model`, `k3_scan_model`), held on the CPU to
the port's plain versions, which tests/test_torch_jpeg_encode.py holds to
the reference's `_jit_encode` / `build_scan_encoder`:

- K2's units (MCUs, or 8x8 blocks for grey) in raster order over the
  batch, rows clamped at load, columns past the image never read, the
  chroma quads clamped inside the unit: the samples `front_samples`
  forms, at odd and even sizes, partial MCUs, tiles that span rows and
  images, one pixel;
- K3's packets from each block's zigzag nonzero mask, tiles of scan
  blocks at their bit alignment with the head word ORed into the
  previous tile's, and the stuffing over chunks of raw bytes, each
  output byte written once: `scan_encode_plain`'s bytes and `nbytes` at
  caps past the scan, inside a tile, at and beside a chunk boundary and
  at 1 byte, with the kernel's tile (256 blocks) and chunk (4,096 bytes)
  and with small ones that make many of both;
- the wrappers' host-side sizes (`scan_sizes`, `encode_kernel_info`'s
  tile count).
"""
import numpy as np
import pytest
import torch

from torch_helpers import (k2_samples_model, k3_scan_model,
                           k3_synthetic_blocks, smooth_rgb)

from picha_tpu.ops.jpeg_huffman_tpu import _mcu_layout
from picha_tpu_torch.ops import jpeg as PJ
from picha_tpu_torch.ops import jpeg_huffman as PH
from picha_tpu_torch.ops.jpeg_write import resized_comp_sig

# (n, h, w, channels)
K2_SHAPES = [(2, 37, 45, 3), (2, 36, 52, 3), (3, 40, 200, 3),
             (2, 17, 33, 3), (2, 37, 45, 1), (3, 24, 200, 1), (1, 1, 1, 3),
             (1, 1, 1, 1), (1, 16, 16, 3)]


@pytest.mark.parametrize("n,h,w,c", K2_SHAPES)
def test_k2_samples_model_matches_front_samples(n, h, w, c):
    rng = np.random.default_rng(n * h * w + c)
    f255 = rng.uniform(-30.0, 285.0, (n, h, w, c)).astype(np.float32)
    f255[0] = smooth_rgb(h, w, 3)[..., :c]
    got = k2_samples_model(f255)
    want = PJ.front_samples(torch.as_tensor(f255))
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt.numpy())


def _scan_inputs(kind, n, h, w, c, seed):
    if kind == "waves":
        f255 = np.stack([smooth_rgb(h, w, seed + i)[..., :c]
                         for i in range(n)]).astype(np.float32)
        ql, qc = PJ.quality_tables(85)
        planes = PJ.encode_blocks(
            torch.as_tensor(f255), torch.as_tensor(ql.astype(np.int32)),
            torch.as_tensor(qc.astype(np.int32)),
            torch.as_tensor(PJ._idct_kron()))
        planes = tuple(p.numpy() for p in planes)
    else:
        planes = k3_synthetic_blocks(kind, n, h, w, c, seed)
    layout = [np.asarray(a, np.int32)
              for a in _mcu_layout(resized_comp_sig(h, w, c))]
    return planes, layout


# name: (kind, n, h, w, channels)
K3_CASES = {
    "waves": ("waves", 2, 64, 96, 3),
    "waves_odd_dummies": ("waves", 2, 37, 45, 3),
    "waves_grey": ("waves", 2, 37, 45, 1),
    "zeros": ("zeros", 1, 70, 90, 3),
    "zrl": ("zrl", 2, 48, 64, 3),
    "size11": ("size11", 1, 40, 56, 3),
    "ff": ("ff", 1, 40, 48, 3),
}


@pytest.mark.parametrize("tile,chunk", [(256, 4096), (8, 16)])
@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_scan_model_matches_plain(name, tile, chunk):
    kind, n, h, w, c = K3_CASES[name]
    planes, (gidx, dummy, tid, prev) = _scan_inputs(kind, n, h, w, c, 5)
    tab = PH.code_table()
    layout = PH.ScanLayout(*(torch.as_tensor(a) for a in
                             (gidx, dummy.astype(np.int32), tid, prev)))
    tplanes = tuple(torch.as_tensor(p) for p in planes)
    big = PH.scan_encode_plain(tplanes, layout, torch.as_tensor(tab),
                               1 << 20)[1]
    longest = int(big.max())
    caps = {1, 3, 1000, 4095, 4096, 4097, longest - 1, longest,
            longest + 1, longest + 4099}
    for cap in sorted(x for x in caps if x >= 1):
        want, nb_want = PH.scan_encode_plain(tplanes, layout,
                                             torch.as_tensor(tab), cap)
        got, nb = k3_scan_model(planes, gidx, dummy, tid, prev, tab, cap,
                                tile=tile, chunk=chunk)
        np.testing.assert_array_equal(nb, nb_want.numpy())
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n,nblk,cap", [(1, 1, 1), (16, 12240, 98304),
                                        (3, 257, 4099), (2, 256, 4096)])
def test_k3_scan_sizes(n, nblk, cap):
    nwords, sync_len = PH.scan_sizes(n, nblk, cap)
    assert nwords % 4 == 0 and 4 * nwords >= cap > 4 * (nwords - 4)
    tiles = n * -(-nblk // PH.TILE_BLOCKS)
    chunks = n * -(-cap // PH.CHUNK_BYTES)
    assert sync_len % 2 == 0 and 0 <= sync_len - (2 + 3 * tiles + chunks) < 2


def test_k2_biased_colour_sums_equal_jccolor():
    """K2 forms Y, Cb and Cr from packed samples that still carry the
    2^23-scale bias of its floor (0x4B400000 + s) in uint32 arithmetic:
    the bias has 16 low zero bits and the weights sum to 65536 (Y) or 0
    (Cb, Cr), so every sum equals jccolor's, mod 2^32 and then exactly,
    for all 2^24 (r, g, b)."""
    from picha_tpu_torch.ops.jpeg import FIX, rgb_to_ycbcr

    bias = np.uint32(0x4B400000)
    g, b = (a.ravel() for a in np.meshgrid(np.arange(256), np.arange(256),
                                           indexing="ij"))
    wy = [np.uint32(FIX(x)) for x in (0.29900, 0.58700, 0.11400)]
    wcb = [np.uint32(FIX(x)) for x in (0.16874, 0.33126, 0.50000)]
    wcr = [np.uint32(FIX(x)) for x in (0.50000, 0.41869, 0.08131)]
    chroma_bias = np.uint32((128 << 16) + 32768 - 1)
    gb = (g.astype(np.uint32) + bias, b.astype(np.uint32) + bias)
    for r in range(256):
        want = rgb_to_ycbcr(torch.as_tensor(
            np.stack([np.full_like(g, r), g, b], -1).astype(np.int32)))
        rb = np.uint32(r) + bias
        with np.errstate(over="ignore"):
            y = (wy[0] * rb + wy[1] * gb[0] + wy[2] * gb[1]
                 + np.uint32(32768)) >> 16
            cb = (wcb[2] * gb[1] - wcb[0] * rb - wcb[1] * gb[0]
                  + chroma_bias) >> 16
            cr = (wcr[0] * rb - wcr[1] * gb[0] - wcr[2] * gb[1]
                  + chroma_bias) >> 16
        for got, w in zip((y, cb, cr), want):
            np.testing.assert_array_equal(got.astype(np.int64), w.numpy())
