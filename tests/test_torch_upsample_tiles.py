"""A numpy model of K7's tiled builds (`csrc/jpeg_upsample_color.cu`:
YCbCr h2v2, h2v1, h1v1, grey to 1 or 3 channels) held bit for bit to the
port's plain `upsample_color_plain` and to the reference's
`picha_tpu/ops/jpeg_tpu.py` upsample and colour functions (JAX on the
CPU) on the same planes.

The model runs the kernel's decomposition: the grid (512-pixel segments,
bands of units of 4 warps, images), a thread's 16 pixels; chroma strips
of 8 columns with the neighbour columns from the lanes beside (a shuffle)
or loaded at the warp's ends, the plane's last column replicated past
it, bytes past a load's valid count left as garbage; at h2v2 the three
chroma rows kept down the band and the column sums 3 * c0 + c_neighbour
shared by both output columns; the fixed-point colour transform; the
thread's bytes packed into a shared row and stored by the warp in
16-byte words assembled by the same barrel shift, into an output that
starts at every byte offset 0-15 and as a sentinel, each byte written
exactly once. Nothing here calls picha_tpu/native."""
import numpy as np
import pytest
import torch

from picha_tpu.ops import jpeg_tpu as ref
from picha_tpu.ops.jpeg_tpu import CS_YCBCR

from picha_tpu_torch.ops.jpeg import (K7_BUILDS, K7_SIGNATURES, comp_sig_of,
                                      plane_geometry, upsample_color_plain)

WARPS, PIX = 4, 16                 # csrc/jpeg_upsample_color.cu
SPAN = 32 * PIX
GARBAGE = 0xA5                     # bytes past a load's valid count
SENTINEL = -1

# (width, height): K7_PLANES' sizes of the card tests, even widths whose
# chroma edge falls inside a thread's strip (530: 265 chroma columns),
# 1-row and 1-column images, and the main path's 1920x1088
SIZES = [(77, 115), (61, 90), (45, 37), (35, 27), (530, 7), (46, 38),
         (1, 9), (33, 1), (1920, 1088)]


def _ycc(y, cb, cr):
    cbs, crs = cb - 128, cr - 128
    r = y + ((91881 * crs + 32768) >> 16)
    g = y + ((-22554 * cbs - 46802 * crs + 32768) >> 16)
    b = y + ((116130 * cbs + 32768) >> 16)
    return [np.clip(v, 0, 255) for v in (r, g, b)]


def _load(row, x0, valid):
    """load_bytes: the bytes row[x0 .. x0 + len) for the lanes' valid
    counts, garbage past them, zeros where nothing is valid.
    x0, valid: (32,); -> (32, n) for n = 8 or 16 by the caller."""
    def take(n):
        t = np.arange(n)[None, :]
        col = np.clip(x0[:, None] + t, 0, row.size - 1)
        v = np.where(t < valid[:, None], row[col], GARBAGE)
        return np.where(valid[:, None] > 0, v, 0).astype(np.int64)
    return take


def load_strip(row, wc, j0):
    """The 10-column window (j0 - 1 .. j0 + 8) of each lane: load_strip."""
    valid = wc - j0
    own = _load(row, j0, np.minimum(valid, 8))(8)
    part = (valid > 0) & (valid < 8)
    last = own[np.arange(32), np.clip(valid - 1, 0, 7)]
    own = np.where(part[:, None] & (np.arange(8)[None, :] >= valid[:, None]),
                   last[:, None], own)
    prev7 = np.concatenate([own[:1, 7], own[:-1, 7]])     # shfl_up by 1
    next0 = np.concatenate([own[1:, 0], own[-1:, 0]])     # shfl_down by 1
    if 0 < j0[0] <= wc:
        prev7[0] = row[j0[0] - 1]
    if j0[31] + 8 < wc:
        next0[31] = row[j0[31] + 8]
    ln = np.where(j0 == 0, own[:, 0], prev7)
    rn = np.where(j0 + 8 < wc, next0, own[:, 7])
    return np.concatenate([ln[:, None], own, rn[:, None]], 1)


def h2(cs, fy):
    """The h2 triangle from the window's column sums (h2v2) or samples
    (h2v1), cs (32, 10) -> the thread's 16 pixels (32, 16): pixel 2t's
    far neighbour is column t - 1, pixel 2t + 1's column t + 1."""
    near = 3 * cs[:, 1:9]
    if fy == 2:
        even, odd = (near + cs[:, 0:8] + 8) >> 4, (near + cs[:, 2:10] + 7) >> 4
    else:
        even, odd = (near + cs[:, 0:8] + 1) >> 2, (near + cs[:, 2:10] + 2) >> 2
    return np.stack([even, odd], -1).reshape(32, PIX)


def store_row(stage, buf, at, n, counts):
    """store_row: n bytes of the stage row to buf[at ..], by 16-byte words
    of the buffer's own alignment (at mod 16), each assembled from two
    stage words by the kernel's barrel shift."""
    d = at % 16
    g0 = at - d
    nw = (d + n + 15) >> 4
    st = stage[:16 * nw].astype(np.uint8).view("<u4").astype(np.uint64)
    v = st.reshape(nw, 4)
    if d:
        a = np.concatenate([np.zeros((1, 4), np.uint64), v[:-1]])
        u = np.concatenate([a, v], 1)
        e = 16 - d
        if e & 8:
            u[:, :6] = u[:, 2:8].copy()
        if e & 4:
            u[:, :7] = u[:, 1:8].copy()
        sh = np.uint64((e & 3) * 8)
        v = ((u[:, 1:5] << np.uint64(32) | u[:, :4]) >> sh) & np.uint64(
            0xFFFFFFFF)
    word = v.astype("<u4").view(np.uint8).reshape(nw, 16).astype(np.int64)
    o = 16 * np.arange(nw)[:, None] - d + np.arange(16)[None, :]
    whole = ((o[:, :1] >= 0) & (o[:, -1:] < n))
    keep = whole | ((o >= 0) & (o < n))
    idx = (g0 + 16 * np.arange(nw)[:, None] + np.arange(16)[None, :])[keep]
    buf[idx] = word[keep]
    counts[idx] += 1


def tiled_upsample_color(planes, samp, width, height, force_rgb, band=8,
                         offset=0):
    """K7's tiled build on uint8 planes [(N, dh, dw)] -> (N, height,
    width, C) uint8, the output written at byte `offset` of its buffer."""
    grey = len(samp) == 1
    c = 3 if not grey or force_rgb else 1
    fx, fy = (1, 1) if grey else (samp[0][0] // samp[1][0],
                                  samp[0][1] // samp[1][1])
    n = planes[0].shape[0]
    buf = np.full(offset + n * height * width * c + 16, SENTINEL, np.int64)
    counts = np.zeros(buf.size, np.int64)
    units = (height + 1) // 2 if fy == 2 else height
    gx = -(-width // SPAN)
    gy = -(-units // (WARPS * band))
    lane = np.arange(32)
    Y = planes[0].astype(np.int64)
    B = None if grey else planes[1].astype(np.int64)
    R = None if grey else planes[2].astype(np.int64)
    for img in range(n):
        for bx in range(gx):
            seg_x = bx * SPAN
            seg_n = min(SPAN, width - seg_x) * c
            x0 = seg_x + lane * PIX
            y_valid = np.minimum(width - x0, PIX)
            j0 = x0 // fx
            for by in range(gy):
                for w in range(WARPS):
                    u0 = (by * WARPS + w) * band
                    u1 = min(u0 + band, units)

                    def emit(y, cb, cr):
                        yc = _load(Y[img, y], x0, y_valid)(PIX)
                        ch = [yc] * c if grey else _ycc(yc, cb, cr)
                        stage = np.full(SPAN * c + 32, GARBAGE, np.int64)
                        stage[:SPAN * c] = np.stack(ch, -1).reshape(-1)
                        at = offset + ((img * height + y) * width + seg_x) * c
                        store_row(stage, buf, at, seg_n, counts)

                    if grey or fx == 1:
                        for u in range(u0, u1):
                            cb = cr = None
                            if not grey:
                                cb = _load(B[img, u], x0, y_valid)(PIX)
                                cr = _load(R[img, u], x0, y_valid)(PIX)
                            emit(u, cb, cr)
                    elif fy == 1:
                        for u in range(u0, u1):
                            wb = load_strip(B[img, u], B.shape[2], j0)
                            wr = load_strip(R[img, u], R.shape[2], j0)
                            emit(u, h2(wb, 1), h2(wr, 1))
                    else:
                        hc, wc = B.shape[1], B.shape[2]

                        def strips(i):
                            return (load_strip(B[img, i], wc, j0),
                                    load_strip(R[img, i], wc, j0))
                        if u0 >= units:
                            continue
                        prev = strips(max(u0 - 1, 0))
                        cur = strips(min(u0, hc - 1))
                        for u in range(u0, u1):
                            nxt = strips(min(u + 1, hc - 1))
                            for half in (0, 1):
                                y = 2 * u + half
                                if y >= height:
                                    break
                                other = nxt if half else prev
                                cs = [3 * cur[k] + other[k] for k in (0, 1)]
                                emit(y, h2(cs[0], 2), h2(cs[1], 2))
                            prev, cur = cur, nxt
    body = slice(offset, offset + n * height * width * c)
    assert (counts[body] == 1).all(), "an output byte written != once"
    assert (counts[:offset] == 0).all() and (counts[body.stop:] == 0).all()
    return buf[body].reshape(n, height, width, c).astype(np.uint8)


def ref_from_planes(planes, samp, width, height, force_rgb):
    """build_decode_stage's body after the IDCT (jpeg_tpu.py:234-260),
    through the reference's own upsample_to and ycbcr_to_rgb_int."""
    import jax.numpy as jnp

    max_h = max(h for h, _ in samp)
    max_v = max(v for _, v in samp)
    up = []
    for p, (hs, vs) in zip(planes, samp):
        p = jnp.asarray(p.astype(np.int32))
        if (hs, vs) != (max_h, max_v):
            p = ref.upsample_to(p, max_h // hs, max_v // vs, height, width)
        else:
            p = p[..., :height, :width]
        up.append(p)
    if len(up) == 1:
        return np.asarray(jnp.stack([up[0]] * 3, -1) if force_rgb
                          else up[0][..., None])
    return np.asarray(ref.ycbcr_to_rgb_int(*up[:3]))


def _planes(samp, width, height, seed, n=1):
    rng = np.random.default_rng(seed)
    sig = comp_sig_of(samp, width, height)
    return sig, [rng.integers(0, 256, (n, dh, dw), np.uint8)
                 for dh, dw, _fx, _fy in plane_geometry(sig, width, height)]


@pytest.mark.parametrize("size", SIZES[:-1])
@pytest.mark.parametrize("name", list(K7_SIGNATURES))
def test_model_matches_plain_and_reference(name, size):
    """Every compiled-in signature at widths and heights that are not
    multiples of the tile, two images, bands of 1 and 8 units, the output
    at byte offsets 0 and 7; the reference at the first size (the plain
    version is held to it at every size of test_torch_decode_stage.py;
    each new shape costs the reference's eager ops a compile)."""
    samp, cs, force = K7_SIGNATURES[name]
    width, height = size
    sig, planes = _planes(samp, width, height, width + height, n=2)
    want = upsample_color_plain([torch.from_numpy(p) for p in planes], sig,
                                cs, width, height, force).numpy()
    if size == SIZES[0]:
        np.testing.assert_array_equal(
            ref_from_planes(planes, samp, width, height, force), want)
    for band, offset in ((1, 7), (8, 0)):
        got = tiled_upsample_color(planes, samp, width, height, force, band,
                                   offset)
        np.testing.assert_array_equal(got, want)


def test_signature_table_names_the_compiled_in_builds():
    """`K7_SIGNATURES` holds every build of `K7_BUILDS` but the generic
    one, and `comp_sig_of` rounds planes up to whole MCUs."""
    assert tuple(K7_SIGNATURES) == K7_BUILDS[:-1]
    assert K7_BUILDS[-1] == "generic"
    assert comp_sig_of(K7_SIGNATURES["h2v2"][0], 1920, 1080) == (
        (136, 240, 2, 2), (68, 120, 1, 1), (68, 120, 1, 1))
    assert comp_sig_of(K7_SIGNATURES["h2v1"][0], 33, 9) == (
        (2, 6, 2, 1), (2, 3, 1, 1), (2, 3, 1, 1))


@pytest.mark.parametrize("name", list(K7_SIGNATURES))
def test_model_at_1080p(name):
    """One 1920x1088 image of each signature (the main path's size: a
    segment of 384 pixels at the right edge), the output at byte offset
    3, against the plain version and the reference."""
    samp, cs, force = K7_SIGNATURES[name]
    sig, planes = _planes(samp, 1920, 1088, len(name))
    got = tiled_upsample_color(planes, samp, 1920, 1088, force, 8, 3)
    want = upsample_color_plain([torch.from_numpy(p) for p in planes], sig,
                                cs, 1920, 1088, force).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ref_from_planes(planes, samp, 1920, 1088, force), want)


@pytest.mark.parametrize("offset", range(16))
def test_store_row_alignments(offset):
    """Every output alignment through the barrel shift, on a 4:2:0 image
    33 pixels wide (99-byte rows: every row starts at another offset)."""
    samp, cs, force = K7_SIGNATURES["h2v2"]
    sig, planes = _planes(samp, 33, 5, offset)
    got = tiled_upsample_color(planes, samp, 33, 5, force, 2, offset)
    want = upsample_color_plain([torch.from_numpy(p) for p in planes], sig,
                                cs, 33, 5, force).numpy()
    np.testing.assert_array_equal(got, want)


def test_reference_composition_is_build_decode_stage():
    """ref_from_planes is the reference's own stage on its own planes:
    build_decode_stage on coefficients equals it on the planes
    dequant_idct_plane gives (4:2:0, 77x115)."""
    from torch_helpers import synthetic_coefs

    samp = K7_SIGNATURES["h2v2"][0]
    sig, coefs, qtabs = synthetic_coefs(77, 115, samp, seed=3)
    geom = plane_geometry(sig, 77, 115)
    planes = [np.asarray(ref.dequant_idct_plane(c, q, dh, dw)).astype(np.uint8)
              for c, q, (dh, dw, _fx, _fy) in zip(coefs, qtabs, geom)]
    want = np.asarray(ref.build_decode_stage(sig, CS_YCBCR, 77, 115)(
        coefs, qtabs))
    np.testing.assert_array_equal(ref_from_planes(planes, samp, 77, 115,
                                                  False), want)
    np.testing.assert_array_equal(
        tiled_upsample_color(planes, samp, 77, 115, False), want)
