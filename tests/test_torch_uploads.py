"""The host-coefficient uploads of JpegBatchPipeline (upload="dense",
"sparse", "int8", "gap8", "gap4") on the CPU, against picha_tpu (JAX on
the CPU), without picha_tpu/native:

- the port's numpy entropy decoder (`ops/jpeg_scan.py::decode_reference`,
  the plain version of the host C++ decoder) equals the reference's bit
  for bit, on Pillow-written baseline JPEGs with and without restart
  markers, 4:2:0 and grey, and one at q = 100 (coefficients past int8, so
  that corrections occur);
- the port's `stack_bucket` output goes unchanged into the reference's
  `_jit_batch_graph` (and, for gap4, `unpack_gap4_wire`), whose pixels are
  the port's CPU pipeline's: this pins the wire format and the restores
  together;
- the reference's own restores (the closures of its batch graph, and
  `gap4_restore_flat`) give back the coefficients exactly from the port's
  packs, on the corpus and on planes built to strain the wire (gaps past
  255, escapes, corrections, an all-zero plane, a last coefficient that is
  nonzero);
- each K27-K30 plain version equals the reference's restore on those
  wires, and the wrappers take it for CPU tensors;
- every upload x fused gives `upload="scan"`'s bytes, and a file the host
  decoder does not take goes to the Pillow pixel route, counted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import pil_jpeg, repeated_index_wires, smooth_rgb

from picha_tpu.ops import jpeg_scan as ref_scan
from picha_tpu.pipeline import jpeg_batch as ref_jb
from picha_tpu_torch.ops import coef_host, coef_restore
from picha_tpu_torch.ops.jpeg_scan import decode_reference, parse_baseline
from picha_tpu_torch.pipeline import JpegBatchPipeline
from picha_tpu_torch.pipeline import jpeg_batch as port_jb

UPLOADS = ["dense", "sparse", "int8", "gap8", "gap4"]
W, H = 32, 24


def _noisy(h, w, seed, sigma=40.0):
    rng = np.random.default_rng(seed)
    base = smooth_rgb(h, w, seed).astype(np.float32)
    return np.clip(base + sigma * rng.standard_normal(base.shape), 0,
                   255).astype(np.uint8)


def _files():
    """name -> JPEG bytes: 4:2:0 with restart markers, without, grey, and
    q = 100 (coefficients past int8)."""
    return {
        "restart": pil_jpeg(_noisy(48, 64, 1), quality=85,
                            restart_marker_blocks=2),
        "no_restart": pil_jpeg(_noisy(48, 64, 2), quality=85),
        "grey": pil_jpeg(_noisy(40, 56, 3)[..., 0], quality=85),
        "q100": pil_jpeg(_noisy(48, 64, 4, 90.0), quality=100),
    }


FILES = _files()
COLOUR = [FILES["restart"], FILES["no_restart"], FILES["q100"]]


@pytest.mark.parametrize("name", sorted(FILES))
def test_decode_reference_matches_reference(name):
    buf = FILES[name]
    got = decode_reference(parse_baseline(buf))
    want = ref_scan.decode_reference(ref_scan.parse_baseline(buf))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and np.array_equal(g, w)
    if name == "q100":
        assert max(int(np.abs(p).max()) for p in got) > 127


def _cos(bufs):
    return coef_host.entropy_decode([parse_baseline(b) for b in bufs],
                                    native=False)


def _ref_inner(sig, **kw):
    """The reference's batch graph for sig (decode only, staged) and the
    Python function inside its jit (whose closures hold the restores)."""
    fn = ref_jb._jit_batch_graph(sig, None, None, "cubic", 1.0, False, None,
                                 **kw)
    return fn, fn.__wrapped__


def _closure(inner, name):
    return inner.__closure__[inner.__code__.co_freevars.index(name)] \
        .cell_contents


@pytest.mark.parametrize("upload", UPLOADS)
def test_stack_bucket_feeds_reference_graph(upload):
    """The port's wire, unchanged, through the reference's graph: the
    pixels of the port's CPU pipeline (decode only, staged)."""
    pipe = JpegBatchPipeline(encode_quality=None, fused=False, upload=upload,
                             device="cpu")
    cos = pipe.entropy_decode(COLOUR)
    packed = pipe.stack_bucket(cos)
    if upload == "dense":
        sig, args = packed
        kw = {}
    else:
        sig, ks, args = packed
        kw = {upload + "_ks": ks}
    fn, _ = _ref_inner(sig, **kw)
    want = np.asarray(fn(*args))
    got = pipe(COLOUR)
    assert pipe.scan_fallbacks == 0
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_gap4_wire_through_reference_unpack():
    """The port's gap4 wire through the reference's unpack_gap4_wire: the
    coefficients and qtables exactly."""
    cos = _cos(COLOUR)
    sig, ks, wire = port_jb.stack_gap4_wire(cos)
    coefs, qtabs = ref_jb.unpack_gap4_wire(wire, ks, sig[3])
    for i in range(len(sig[3])):
        want = np.stack([co.comps[i]["coefs"] for co in cos])
        assert np.array_equal(np.asarray(coefs[i]), want)
        assert np.array_equal(np.asarray(qtabs[i])[:, 0, 0],
                              np.stack([co.comps[i]["qtable"] for co in cos]))
    got, gq = coef_restore.unpack_gap4_wire(torch.from_numpy(wire), ks,
                                            sig[3])
    for i in range(len(sig[3])):
        assert np.array_equal(got[i].numpy(), np.asarray(coefs[i]))
        assert np.array_equal(gq[i].numpy(), np.asarray(qtabs[i]))


def _strained(seed, shape=(2, 3, 4, 64)):
    """Planes that strain the wires: runs of zeros past 255 and 15,
    values past 7 (gap4 escapes) and past 127 (corrections), a first
    coefficient nonzero, one plane all zero, the last coefficient
    nonzero in another."""
    rng = np.random.default_rng(seed)
    c = np.zeros(shape, np.int16)
    flat = c.reshape(shape[0], -1)
    for j in range(1, shape[0]):
        nz = rng.choice(flat.shape[1], flat.shape[1] // 12, replace=False)
        flat[j, nz] = rng.integers(-9, 10, nz.size)
        flat[j, rng.choice(flat.shape[1], 6)] = rng.integers(-900, 900, 6)
        flat[j, 0] = 3
        flat[j, 300:700] = 0
        flat[j, -1] = -200 if j % 2 else 0
    return [c[j] for j in range(shape[0])]      # plane 0 stays all zero


def _wires(planes):
    """Each upload's stack of the planes as a one-component grey batch."""
    cos = [coef_host.JpegCoefficients.from_parts(
        p.shape[1] * 8, p.shape[0] * 8, 1, [{
            "h_samp": 1, "v_samp": 1, "blocks_w": p.shape[1],
            "blocks_h": p.shape[0], "width": p.shape[1] * 8,
            "height": p.shape[0] * 8,
            "qtable": np.arange(1, 65, dtype=np.uint16), "coefs": p}])
        for p in planes]
    return {u: port_jb.stack_coefficients(cos, u) for u in UPLOADS[1:]}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("upload", UPLOADS[1:])
def test_reference_restore_gives_back_the_coefficients(upload, seed):
    """Pack (the port's numpy packers) -> the reference's own JAX restore
    (its graph's densify / int8_restore / gap8 unpack + restore, and
    gap4_restore_flat) -> the planes exactly; each K27-K30 plain version
    equal to it; the wrappers take the plain version for CPU tensors."""
    planes = _strained(seed)
    want = np.stack(planes)
    sig, ks, args = _wires(planes)[upload]
    bh, bw = sig[3][0][:2]
    _, inner = _ref_inner(sig, **{upload + "_ks": ks})
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    args = [jnp.asarray(a) for a in args]
    if upload == "sparse":
        ref = _closure(inner, "densify")(args[0], args[1], bh, bw)
        got = coef_restore.densify_plain(t[0], t[1], bh, bw)
        wrap = coef_restore.densify(t[0], t[1], bh, bw)
    elif upload == "int8":
        ref = _closure(inner, "int8_restore")(*args[:3])
        got = coef_restore.int8_restore_plain(*t[:3])
        wrap = coef_restore.int8_restore(*t[:3])
    elif upload == "gap8":
        parts, _q = _closure(inner, "unpack_gap8")(args[0])
        ref = _closure(inner, "gap8_restore")(*parts[0], bh, bw)
        ports, _pq = coef_restore.unpack_gap8(t[0], ks, 1)
        got = coef_restore.gap8_restore_plain(*ports[0], bh, bw)
        wrap = coef_restore.gap8_restore(*ports[0], bh, bw)
        assert int((ports[0][2] != ports[0][0].shape[0] * bh * bw * 64 - 1)
                   .sum()) > 0                        # corrections occur
    else:
        coefs, _q = ref_jb.unpack_gap4_wire(args[0], ks, sig[3])
        ref = coefs[0]
        ports, _pq = coef_restore.unpack_gap4(t[0], ks, 1)
        got = coef_restore.gap4_restore_plain(*ports[0], bh, bw)
        wrap = coef_restore.gap4_restore(*ports[0], bh, bw)
        assert int(((ports[0][0] & 15) == 15).sum()) > 0   # escapes occur
    ref = np.asarray(ref).reshape(want.shape)
    assert np.array_equal(ref, want)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(wrap, got)


@pytest.mark.parametrize("upload", UPLOADS[1:])
def test_restores_add_every_entry_at_repeated_indices(upload):
    """Wires that repeat indices (zero gaps, the index-0 clamp, duplicate
    sorted indices and corrections; no packer writes them): each plain
    restore adds every entry, as the reference's scatter-add does."""
    n, bh, bw = 3, 2, 3
    wire = repeated_index_wires(7, n, bh, bw)[upload]
    sig = (bw * 8, bh * 8, 1, ((bh, bw, 1, 1),))
    t = [torch.from_numpy(a) for a in wire]
    j = [jnp.asarray(a) for a in wire]
    if upload == "gap4":
        ref = ref_jb.gap4_restore_flat(*j, bh, bw)
        got = coef_restore.gap4_restore_plain(*t, bh, bw)
    else:
        ks = ((n, ((wire[0].shape[1], wire[2].size),)) if upload == "gap8"
              else (wire[0].shape[-1],))
        _, inner = _ref_inner(sig, **{upload + "_ks": ks})
        name = {"sparse": "densify", "int8": "int8_restore",
                "gap8": "gap8_restore"}[upload]
        extra = () if upload == "int8" else (bh, bw)
        ref = _closure(inner, name)(*j, *extra)
        got = {"sparse": coef_restore.densify_plain,
               "int8": coef_restore.int8_restore_plain,
               "gap8": coef_restore.gap8_restore_plain}[upload](*t, *extra)
    ref = np.asarray(ref).reshape(n, bh, bw, 64)
    assert np.array_equal(got.numpy(), ref)


def test_numpy_packers_follow_the_wire_rules():
    """The padding rules, read off the packers' bytes: gap8 pins the last
    index with a zero pair and splits gaps past 255; gap4 rows pad with
    0x07 and (0, 0), the corrections with (nb * n - 1, 0)."""
    planes = _strained(2)
    g, v, ci, cv = coef_host.gap8_pack_plain(planes[0])
    n = planes[0].size
    assert v[-1] == 0 and int(g.astype(np.int64).sum()) - 1 == n - 1
    assert ci.size == 0 and (g[:-1] == 255).all()       # the all-zero plane
    g, v, ci, cv = coef_host.gap8_pack_plain(planes[1])
    idx = np.cumsum(g.astype(np.int64)) - 1
    flat = planes[1].reshape(-1).astype(np.int32)
    dense = np.zeros(n, np.int32)
    np.add.at(dense, idx, v.astype(np.int32))
    np.add.at(dense, ci, cv.astype(np.int32))
    assert np.array_equal(dense, flat) and ci.size > 0
    k1, k2, kc, prim, sg, sv, ci, cv = coef_host.gap4_pack_batch(planes)
    assert k1 % 8192 == 0 and k2 % 4096 == 0 and kc % 1024 == 0
    # the all-zero plane: gap n as (15, 7) extensions, the pin, the padding
    nd = (n - 1) // 15
    assert prim[0].tolist() == [15 << 4 | 7] * nd + [
        (n - 15 * nd) << 4 | 7] + [7] * (k1 - nd - 1)
    assert (sg[:, -1] == 0).all() and (sv[:, -1] == 0).all()
    assert ci[-1] == len(planes) * n - 1 and cv[-1] == 0


@pytest.mark.parametrize("fused", [False, True])
def test_uploads_give_the_scan_bytes(fused):
    """Each upload's transcode on the CPU: upload="scan"'s bytes (the same
    coefficients enter the same graph)."""
    kw = dict(width=W, height=H, encode_quality=85, fused=fused,
              encode_backend="device", device="cpu")
    want = JpegBatchPipeline(upload="scan", **kw)(COLOUR)
    for upload in UPLOADS:
        pipe = JpegBatchPipeline(upload=upload, num_threads=2, **kw)
        got = pipe(COLOUR)
        assert pipe.scan_fallbacks == 0
        assert [bytes(g) for g in got] == [bytes(w) for w in want], upload


def test_upload_normalize_and_mixed_signatures():
    """normalize (float 0-1 images) and a batch of two signatures through
    gap8 and int8: the scan upload's tensors."""
    bufs = COLOUR[:2] + [FILES["grey"]]
    for kw in (dict(normalize=True), dict(encode_quality=None)):
        want = JpegBatchPipeline(width=W, height=H, upload="scan",
                                 device="cpu", **kw)(bufs)
        for upload in ("gap8", "int8"):
            got = JpegBatchPipeline(width=W, height=H, device="cpu",
                                    upload=upload, **kw)(bufs)
            assert torch.equal(got, want)


def test_upload_overflow_retries_then_host_encode():
    """The encode overflow path carries the upload: one retry at twice the
    cap, then a raw420 clone with the same upload ("gap4" for "scan", as
    the reference's) encodes on the host; both give the same bytes."""
    kw = dict(width=W, height=H, encode_quality=85, fused=True,
              encode_backend="device", device="cpu")
    outs, counters = [], []
    for up in ("scan", "gap4"):
        p = JpegBatchPipeline(upload=up, **kw)
        p._scan_cap_for = lambda sig: 256
        outs.append([bytes(g) for g in p(COLOUR[:1])])
        counters.append((p.scan_fallbacks, p.overflow_retries,
                         p.overflow_fallbacks))
        assert p._overflow_clone._upload == "gap4"
        assert p._overflow_clone._encode_backend == "raw420"
    assert outs[0] == outs[1] and counters == [(0, 1, 1)] * 2


def test_undecodable_file_takes_the_pixel_route():
    """A progressive file: the host decoder does not take it, so the batch
    is decoded by Pillow and counted, as on the scan path."""
    prog = pil_jpeg(_noisy(48, 64, 5), quality=85, progressive=True)
    assert parse_baseline(prog) is None
    pipe = JpegBatchPipeline(width=W, height=H, encode_quality=85,
                             encode_backend="device", upload="gap4",
                             device="cpu")
    out = pipe([prog, COLOUR[0]])
    assert len(out) == 2 and pipe.scan_fallbacks == 1


def test_unknown_upload_raises():
    with pytest.raises(ValueError):
        JpegBatchPipeline(upload="gap2", device="cpu")
