"""The port's PNG encode filter (K12's plain version on CPU tensors) and
batched encode against picha_tpu's on the same numpy inputs:
byte-identical filtered rows for every strategy and bpp 1-4, 6 and 8
(16-bit samples; first row,
rows no wider than bpp, ties); the reference's validation errors; files
that Pillow decodes to the input exactly, whose inflated IDAT is the
reference's filtered stream for each fixed strategy; and the probe's
pick against the reference's selection rule. Nothing here calls
picha_tpu/native: the reference's side is its JAX `filter_batch`."""
import io
import struct
import zlib

import numpy as np
import pytest
import torch

from picha_tpu.ops.png_filter_tpu import filter_batch as ref_filter_batch

from picha_tpu_torch.codecs.png_host import PROBE_ORDER, probe_pick
from picha_tpu_torch.ops.png_filter import filter_batch, filter_batch_plain
from picha_tpu_torch.pipeline.png_batch import encode_filtered

# (h, w): a tall image, the first row alone, a row of one pixel (as wide
# as bpp, where a and c are 0 throughout)
SHAPES = {"tall": (17, 23), "one_row": (1, 16), "one_column": (6, 1)}


def _rows(h, rb, seed):
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, (3, h, rb), np.uint8)
    batch[1] = (np.arange(rb)[None, :] % 16).astype(np.uint8)   # ties
    batch[2] = 0                                               # all tie
    return batch


@pytest.mark.parametrize("strategy", [-1, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_filter_matches_reference(strategy, bpp, shape):
    h, w = SHAPES[shape]
    batch = _rows(h, w * bpp, seed=h * 10 + bpp)
    want = np.asarray(ref_filter_batch(batch, bpp, strategy))
    got = filter_batch(torch.from_numpy(batch), bpp, strategy)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.empty(want.shape, dtype=torch.uint8)
    assert filter_batch(torch.from_numpy(batch), bpp, strategy, out=out) \
        is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("args", [
    (np.zeros((2, 3, 4), np.uint8), 1, 7), (np.zeros((2, 3, 4), np.uint8),
                                            1, -2),
    (np.zeros((3, 4), np.uint8), 1, -1), (np.zeros((2, 3, 4), np.int32),
                                          1, -1)])
def test_filter_validates_like_reference(args):
    arr, bpp, strategy = args
    with pytest.raises(ValueError) as want:
        ref_filter_batch(arr, bpp, strategy)
    with pytest.raises(ValueError) as got:
        filter_batch_plain(torch.from_numpy(arr), bpp, strategy)
    assert str(got.value) == str(want.value)


def _image(h, w, ch, seed):
    """Photographic-ish content: waves plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 60 * np.sin(xx / 9 + seed) + 40 * np.cos(yy / 5)
    chans = [base, 255 - base, base * 0.6 + 40, base * 0.3 + 150][:ch]
    img = np.stack(chans, -1) + rng.normal(0, 3, (h, w, ch))
    return np.clip(img, 0, 255).astype(np.uint8)


def _idat(png: bytes) -> bytes:
    """The inflated IDAT payload of a PNG file (chunks walked by hand)."""
    pos, data = 8, b""
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            data += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return zlib.decompress(data)


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
@pytest.mark.parametrize("strategy", [None, -1, 0, 1, 2, 3, 4])
def test_encode_filtered_decodes_exactly(ch, strategy):
    """Every file decodes with Pillow to its input; for a fixed
    strategy the inflated stream is the reference's filtered rows."""
    from PIL import Image as PILImage

    batch = np.stack([_image(80, 70, ch, s) for s in range(3)])
    outs = encode_filtered(batch, 4, strategy, device="cpu")
    assert len(outs) == 3
    rows = batch.reshape(3, 80, 70 * ch)
    for i, png in enumerate(outs):
        got = np.asarray(PILImage.open(io.BytesIO(png)))
        np.testing.assert_array_equal(got.reshape(batch[i].shape), batch[i])
        if strategy is not None:
            want = np.asarray(ref_filter_batch(rows[i:i + 1], ch, strategy))
            assert _idat(png) == want.tobytes()


def _reference_probe(cands, h):
    """The reference's selection rule (codecs/png.py::_probe_filter,
    png_batch.encode_filtered) written out, with zlib's level-1 deflate
    in place of libdeflate's: strategies 2, 1, -1 in that order, a
    contiguous middle block of max(8, h // 8) rows, a later candidate
    must be < 0.995 of the incumbent's estimate."""
    n_blk = max(8, h // 8)
    r0 = (h - n_blk) // 2
    best = None
    for i, f in enumerate(cands):
        est = len(zlib.compress(f[r0:r0 + n_blk].tobytes(), 1))
        if best is None or est < best[0] * 0.995:
            best = (est, i)
    return best[1]


def test_probe_picks_follow_the_reference_rule():
    """Images large enough to probe (h >= 16, >= 64 KiB of filtered
    rows): vertical stripes, where up wins, and rows that are ramps of
    random slope, where sub does. Each file's IDAT is the candidate the rule picks from the
    reference's own filtered candidates."""
    rng = np.random.default_rng(0)
    xx = np.arange(160, dtype=np.float32)[None, :]
    stripes = np.clip(127 + 60 * np.sin(xx / np.float32([[9], [4]])), 0,
                      255).astype(np.uint8)                   # (2, 160)
    smooth = np.broadcast_to(stripes[:, None, :, None],
                             (2, 200, 160, 3)).copy()
    off = rng.integers(0, 256, (2, 200, 1, 1))
    slope = rng.integers(1, 7, (2, 200, 1, 1))
    ramps = np.broadcast_to((off + slope * np.arange(160)[:, None]) % 256,
                            (2, 200, 160, 3)).astype(np.uint8)
    picks = []
    for batch in (smooth, ramps):
        rows = batch.reshape(2, 200, 480)
        cands = [np.asarray(ref_filter_batch(rows, 3, s)) for s in PROBE_ORDER]
        outs = encode_filtered(batch, 4, None, device="cpu")
        for i, png in enumerate(outs):
            pick = _reference_probe([c[i] for c in cands], 200)
            assert probe_pick([c[i] for c in cands], 200) == pick
            assert _idat(png) == cands[pick][i].tobytes()
            picks.append(PROBE_ORDER[pick])
    assert picks[:2] == [2, 2]          # stripes: up
    assert picks[2:] == [1, 1]          # ramps: sub


def test_small_images_skip_the_probe():
    """Under 16 rows or 64 KiB the default takes the adaptive filter."""
    batch = np.stack([_image(15, 2000, 3, 1), _image(15, 2000, 3, 2)])
    outs = encode_filtered(batch, 4, None, device="cpu")
    want = np.asarray(ref_filter_batch(batch.reshape(2, 15, 6000), 3, -1))
    for i, png in enumerate(outs):
        assert _idat(png) == want[i].tobytes()


def test_encode_filtered_validates():
    with pytest.raises(ValueError):
        encode_filtered(np.zeros((2, 3, 4), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        encode_filtered(np.zeros((1, 3, 4, 3), np.int32), device="cpu")
    # 16-bit samples encode (as big-endian bytes, bpp 6 here)
    assert encode_filtered(np.zeros((1, 3, 4, 3), np.uint16),
                           device="cpu")[0][24] == 16
    with pytest.raises(ValueError):
        encode_filtered(np.zeros((1, 3, 4, 3), np.uint8), strategy=5,
                        device="cpu")
