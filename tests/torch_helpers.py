"""Shared inputs for the port's tests (tests/test_torch_*.py).

The same numpy inputs go to picha_tpu (JAX on the CPU) and to
picha_tpu_torch. The 1080p corpora under fixtures/port/ (restart-8 and
restart-free encodes of the same pixels) are the main path's input on
machines without the native library (fixtures/port/make_fixtures.py
regenerates them).
"""
import io
import pathlib

import numpy as np

from picha_tpu.ops.jpeg_tpu import CS_GRAYSCALE, CS_RGB, CS_YCBCR, CS_YCCK

PORT_FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "port"
N_FIXTURES = 3


def port_corpus(n: int = 16, restart: bool = True):
    """n 1920x1088 q85 JPEGs, the committed sources tiled: restart-8
    encodes, or with restart=False the same pixels encoded without
    restart markers."""
    stem = "src_" if restart else "src_nr_"
    srcs = [(PORT_FIXTURES / f"{stem}{i}.jpg").read_bytes()
            for i in range(N_FIXTURES)]
    return [srcs[i % N_FIXTURES] for i in range(n)]


def port_refs(n: int = 16):
    """The strict host path's 960x544 q85 output for port_corpus(n)."""
    refs = [(PORT_FIXTURES / f"ref_{i}.jpg").read_bytes()
            for i in range(N_FIXTURES)]
    return [refs[i % N_FIXTURES] for i in range(n)]


def smooth_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """A natural-ish (h, w, 3) uint8 image: waves plus mild noise, so
    scans stay short and the CPU decode loops stay fast."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(1, 4, 2)
    base = (127 + 60 * np.sin(2 * np.pi * fx * xx / w + seed)
            + 50 * np.cos(2 * np.pi * fy * yy / h))
    img = np.stack([base, np.roll(base, 7, 1), np.roll(base, 11, 0)], -1)
    img = img + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def scan_batch_inputs(bufs, device="cpu", **batch_kw):
    """JPEG bytes (or parsed ScanInfos, the reference's or the port's) ->
    (ScanBatch, scan key, port DecoderArgs, qtabs, comp_of tensor) with
    the wire on `device`. `batch_kw` goes to ScanBatch (chunk_bits)."""
    import torch

    from picha_tpu.ops import jpeg_scan
    from picha_tpu.ops.jpeg_huffman_decode_tpu import ScanBatch
    from picha_tpu_torch.ops.jpeg_huffman_decode import wire_unpack

    infos = [jpeg_scan.parse_baseline(bytes(b))
             if isinstance(b, (bytes, bytearray, memoryview)) else b
             for b in bufs]
    assert all(i is not None for i in infos)
    sb = ScanBatch(infos, **batch_kw)
    ks, wire = sb.wire()
    args, qtabs = wire_unpack(torch.from_numpy(wire).to(device), ks,
                              infos[0].ncomp)
    comp_of = torch.as_tensor(sb.comp_of, dtype=torch.int32, device=device)
    return sb, ks, args, qtabs, comp_of


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    """Pillow's (bundled libjpeg) baseline encode of an (h, w, 3) or
    (h, w) uint8 image; works where picha_tpu/native does not build."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def noisy(seed: int, h: int = 120, w: int = 200, c: int = 3) -> np.ndarray:
    """Uniform noise: dense scans, many chunks even for small images."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)
    return img[..., 0] if c == 1 else img


def _chunked_batch():
    smooth = np.clip(np.linspace(0, 255, 200)[None, :, None]
                     + np.zeros((120, 1, 3)), 0, 255).astype(np.uint8)
    return [pil_jpeg(noisy(3), quality=85), pil_jpeg(smooth, quality=90),
            pil_jpeg(noisy(3), quality=40)]


def _image_2k():
    rng = np.random.default_rng(30)
    base = np.clip(np.linspace(0, 255, 2560)[None, :, None]
                   + rng.normal(0, 12, (1440, 2560, 3)), 0, 255)
    return [pil_jpeg(base.astype(np.uint8), quality=85)]


# Valid streams for the chunked decoder (scans without usable restart
# markers): name -> (maker of the JPEG streams, ScanBatch chunk_bits).
# "batch" puts three images in one batch, so a segment's last chunk
# decodes the 1-bit padding after its image's last block next to the
# next image's first block. chunk_bits=512 keeps the JAX reference's CPU
# compile short while small images still span many chunks.
CHUNKED_STREAMS = {
    "batch": (_chunked_batch, 512),
    "grey": (lambda: [pil_jpeg(noisy(4, 64, 100, 1), quality=85)], 512),
    "odd_dims": (lambda: [pil_jpeg(noisy(4, 77, 115), quality=85)], 512),
    "custom_tables": (lambda: [pil_jpeg(noisy(5), quality=80,
                                        optimize=True)], 512),
    "444": (lambda: [pil_jpeg(noisy(20), quality=85, subsampling=0)], 512),
    "422": (lambda: [pil_jpeg(noisy(21), quality=85, subsampling=1)], 512),
    "420": (lambda: [pil_jpeg(noisy(22), quality=85, subsampling=2)], 512),
    "dri_exceeds_mcus": (lambda: [pil_jpeg(noisy(31, 48, 64), quality=85,
                                           restart_marker_blocks=10_000)],
                         512),
    "2560x1440": (_image_2k, 4096),
}

# Chunked-decoder fault cases: a scan cut inside a block, five scans
# with 3 flipped bits each, a pass budget of 1, a symbol budget of 16.
CHUNKED_FAULTS = ["truncated", "flip0", "flip1", "flip2", "flip3", "flip4",
                  "max_passes_1", "tiny_steps"]


def chunked_fault_batch(case: str):
    """(ScanBatch at chunk_bits=512, decoder kwargs) for one of
    CHUNKED_FAULTS, or (None, None) when a flip broke the header. All
    cases share one geometry and table set (one reference compile for
    the stream faults)."""
    from picha_tpu.ops import jpeg_scan
    from picha_tpu.ops.jpeg_huffman_decode_tpu import ScanBatch

    rng = np.random.default_rng(14)
    base = pil_jpeg(noisy(14, 48, 64), quality=85)
    flips = []
    for _ in range(5):
        buf = bytearray(base)
        for _ in range(3):
            buf[rng.integers(len(buf) // 2, len(buf))] ^= 1 << rng.integers(8)
        flips.append(bytes(buf))
    info = jpeg_scan.parse_baseline(
        flips[int(case[4:])] if case.startswith("flip") else base)
    if info is None:
        return None, None
    if case == "truncated":
        info.segments[0] = info.segments[0][: len(info.segments[0]) * 2 // 3]
    sb = ScanBatch([info], chunk_bits=512)
    if case == "tiny_steps":
        sb.steps = 16
    return sb, {"max_passes": 1} if case == "max_passes_1" else {}


def desync_jpeg(h: int = 128, w: int = 128, seed: int = 0) -> bytes:
    """A valid grey baseline JPEG whose scan never resynchronises from a
    guessed entry: 15 codes of each table are 4 bits long (0000-1110),
    every value 0 or 4 bits, and one AC code 11110 (with a 1-bit value)
    is used once, in the first block, so the true symbol boundaries sit
    at 2 mod 4 from there on while every guess (lane or window starts,
    at multiples of 32 or of the window's width) sits at 0 mod 4. The
    later codes and value nibbles all start with a 0 bit, so a
    misaligned 4-bit read (xx0x) never starts 1111 and a guessed path
    stays misaligned: the chunked decoder needs a Jacobi pass a chunk,
    and a windowed lane a round a window."""
    rng = np.random.default_rng(seed)
    # canonical codes: 15 of length 4 (code i -> symbol i), then 11110
    dc_vals = [0, 4] * 7 + [0, 0]                   # DC sizes 0 / 4
    ac_vals = [0x00, 0x04, 0x14, 0xF0] + [0x04] * 11 + [0x01]
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    for blk in range((h // 8) * (w // 8)):
        if rng.random() < 0.5:
            put(0, 4)                                   # DC diff 0
        else:
            put(1, 4)                                   # DC size 4
            put(int(rng.integers(0, 8)), 4)
        if blk == 0:
            put(0b11110, 5)                             # AC size 1: + 1 bit
            put(1, 1)
        z = 1 if blk else 2
        for _ in range(int(rng.integers(0, 5))):
            kind = int(rng.integers(0, 3))
            if kind == 2 and z + 16 < 63:
                put(3, 4)                               # ZRL
                z += 16
            elif z + kind < 63:
                put(1 + kind, 4)                        # run 0 / 1, size 4
                put(int(rng.integers(0, 8)), 4)
                z += 1 + kind
        put(0, 4)                                       # EOB
    bits.extend([1] * (-len(bits) % 8))
    scan = bytearray()
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2)
        scan.append(byte)
        if byte == 0xFF:
            scan.append(0)

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + bytes(body)

    counts = [0, 0, 0, 15, 1] + [0] * 11
    return (b"\xff\xd8"
            + seg(0xDB, [0] + [1] * 64)
            + seg(0xC0, [8, h >> 8, h & 255, w >> 8, w & 255, 1, 1, 0x11, 0])
            + seg(0xC4, [0x00] + counts + dc_vals)
            + seg(0xC4, [0x10] + counts + ac_vals)
            + seg(0xDA, [1, 1, 0x00, 0, 63, 0])
            + bytes(scan) + b"\xff\xd9")


def synthetic_coefs(width: int, height: int, samp, seed: int,
                    qualities=(85, 50)):
    """Quantised DCT blocks of smooth, noisy, in-gamut planes (with some
    flat blocks whose DC is 4 mod 8, so that with an odd DC step their
    IDCT samples land within f32 rounding of a .5 tie), one image
    per entry of `qualities`, each quantised with that quality's
    tables. samp: per component (h_samp, v_samp). Returns (comp_sig,
    coefs [(N, bh, bw, 64) int32], qtabs [(N, 1, 1, 64) int32]) with the
    block grids libjpeg uses (MCU-padded when there are several
    components)."""
    from picha_tpu.ops.jpeg_tpu import idct_matrix, quality_tables

    rng = np.random.default_rng(seed)
    max_h = max(h for h, _ in samp)
    max_v = max(v for _, v in samp)
    comp_sig = []
    for hs, vs in samp:
        if len(samp) == 1:
            comp_sig.append((-(-height // 8), -(-width // 8), hs, vs))
        else:
            comp_sig.append((-(-height // (8 * max_v)) * vs,
                             -(-width // (8 * max_h)) * hs, hs, vs))
    a = idct_matrix().astype(np.float64)
    coefs = [np.zeros((len(qualities), bh, bw, 64), np.int32)
             for bh, bw, _, _ in comp_sig]
    qtabs = [np.zeros((len(qualities), 1, 1, 64), np.int32)
             for _ in comp_sig]
    for n, q in enumerate(qualities):
        qluma, qchroma = quality_tables(q)
        for i, (bh, bw, _, _) in enumerate(comp_sig):
            yy, xx = np.mgrid[0:bh * 8, 0:bw * 8].astype(np.float64)
            fx, fy = rng.uniform(1, 3, 2)
            plane = (128 + 70 * np.sin(2 * np.pi * fx * xx / (bw * 8))
                     * np.cos(2 * np.pi * fy * yy / (bh * 8))
                     + rng.normal(0, 6, yy.shape))
            blocks = np.clip(plane, 20, 235).reshape(bh, 8, bw, 8)
            blocks = blocks.transpose(0, 2, 1, 3).copy()
            flat = rng.random((bh, bw)) < 0.2
            blocks[flat] = rng.integers(20, 236, (int(flat.sum()), 1, 1))
            c = np.einsum("uy,abyx,vx->abuv", a, blocks - 128.0, a)
            qt = (qluma if i == 0 else qchroma).astype(np.int32)
            coefs[i][n] = np.round(c.reshape(bh, bw, 64) / qt)
            dc = coefs[i][n, ..., 0]
            dc[flat] = dc[flat] // 8 * 8 + 4
            qtabs[i][n, 0, 0] = qt
    return tuple(comp_sig), coefs, qtabs


_Y420 = ((2, 2), (1, 1), (1, 1))
_Y422 = ((2, 1), (1, 1), (1, 1))
_Y440 = ((1, 2), (1, 1), (1, 1))

# Staged-decode cases: name -> (width, height, per-component (h_samp,
# v_samp), colour space, force_rgb). Every case carries two images
# quantised with different tables.
DECODE_CASES = {
    "420": (64, 48, _Y420, CS_YCBCR, False),
    "422": (64, 48, _Y422, CS_YCBCR, False),
    "440": (64, 48, _Y440, CS_YCBCR, False),
    "444": (40, 32, ((1, 1),) * 3, CS_YCBCR, False),
    "grey": (45, 37, ((1, 1),), CS_GRAYSCALE, False),
    "grey_force_rgb": (45, 37, ((1, 1),), CS_GRAYSCALE, True),
    "odd_420": (77, 115, _Y420, CS_YCBCR, False),
    "odd_422": (61, 90, _Y422, CS_YCBCR, False),
    "odd_440": (61, 90, _Y440, CS_YCBCR, False),
    "h4v1_replicate": (75, 20, ((4, 1), (1, 1), (1, 1)), CS_YCBCR, False),
    "h2v4_replicate": (30, 70, ((2, 4), (1, 1), (1, 1)), CS_YCBCR, False),
    "rgb": (33, 21, ((1, 1),) * 3, CS_RGB, False),
    "ycck": (34, 26, ((2, 2), (1, 1), (1, 1), (2, 2)), CS_YCCK, False),
}


def synthetic_decode_case(name: str):
    """(width, height, colour space, comp_sig, coefs, qtabs, force_rgb)
    of one of DECODE_CASES, from `synthetic_coefs` seeded by the name."""
    width, height, samp, cs, force = DECODE_CASES[name]
    comp_sig, coefs, qtabs = synthetic_coefs(width, height, samp,
                                             seed=len(name))
    return width, height, cs, comp_sig, coefs, qtabs, force


def xla_same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial axis, (before, after): the
    output has ceil(size / stride) samples, the odd pixel goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv64(x, w, stride=1):
    import torch.nn.functional as F

    (t, b), (l, r) = (xla_same_pads(x.shape[1], w.shape[0], stride),
                      xla_same_pads(x.shape[2], w.shape[1], stride))
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (l, r, t, b)),
                 w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _norm_relu64(x, scale):
    import torch

    mu = x.mean((1, 2), keepdim=True)
    var = ((x - mu) ** 2).mean((1, 2), keepdim=True)
    return torch.relu((x - mu) / torch.sqrt(var + 1e-5) * scale)


def resnet_forward64(params, images):
    """picha_tpu/models/resnet.py::forward (:119-142) with every bf16 cast
    replaced by float64: params a tree of float64 tensors (`proj` None
    where a block keeps its width), images (N, H, W, 3) float64 NHWC ->
    (N, classes) float64 logits. The float64 yardstick of the ResNet's
    gradient criterion (tests/test_torch_resnet.py)."""
    x = _conv64(images, params["stem"])
    for stage in params["stages"]:
        for bi, blk in enumerate(stage):
            stride = 2 if bi == 0 else 1
            h = _conv64(_norm_relu64(x, blk["scale1"]), blk["conv1"], stride)
            h = _conv64(_norm_relu64(h, blk["scale2"]), blk["conv2"])
            shortcut = x
            if blk["proj"] is not None:
                shortcut = _conv64(x, blk["proj"], stride)
            elif stride != 1:
                shortcut = x[:, ::stride, ::stride, :]
            x = h + shortcut
    return x.mean((1, 2)) @ params["head"]


def float64_criterion(got, ref, g64):
    """The ResNet's gradient criterion for one leaf (numpy or tensors):
    ||got - g64|| <= 2 ||ref - g64|| + 1e-2 ||g64||, and where ref itself
    is within 5e-3 of g64, also ||got - ref|| <= 2e-2 ||ref||. Returns
    (passed, ||got - g64|| / (2 ||ref - g64|| + 1e-2 ||g64||))."""
    got, ref, g64 = (np.asarray(a, np.float64) for a in (got, ref, g64))
    n64 = np.linalg.norm(g64)
    ref_err = np.linalg.norm(ref - g64)
    ratio = np.linalg.norm(got - g64) / max(2 * ref_err + 1e-2 * n64, 1e-300)
    ok = ratio <= 1.0
    if ref_err <= 5e-3 * n64:
        ok = ok and np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    return bool(ok), float(ratio)


# --- K18 / K22's tensor-core arithmetic, emulated on the CPU -------------
# (tests/test_torch_attention_numerics.py). An mma.sync.m16n8k16 adds 16
# exact bf16 x bf16 products to an f32 accumulator and truncates: each
# step here is the exact sum (float64) of the accumulator and the 16
# products, rounded toward zero to f32. The kernels take the scores and dP
# one step at a time from a zero accumulator, adding the steps with
# round-to-nearest (`_tc_rn`), and chain every other product in the
# accumulator (`_tc`); K22 sums l and c in float64 and rounds once
# (`_sum_rn`), K18 sums l in f32. Where the hardware truncates the products as it
# aligns them inside a step, this model does not.

def _rz(x):
    """float64 -> float32, rounded toward zero."""
    import torch

    f = x.to(torch.float32)
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _tc(parts, b):
    """sum over the a in `parts` of a (.., M, K) @ b (.., K, N), 16 deep
    at a time, each part's step into one accumulator (K22 takes dS as two
    parts)."""
    import torch

    acc = None
    b = b.double()
    for k0 in range(0, b.shape[-2], 16):
        bb = b[..., k0:k0 + 16, :]
        for a in parts:
            step = a[..., k0:k0 + 16].double() @ bb
            acc = _rz(step if acc is None else acc.double() + step)
    return acc.to(torch.float32)


def _tc_rn(a, b):
    """a @ b as the kernels take the scores and dP: each 16-deep step from
    a zero accumulator, the steps added with round-to-nearest."""
    acc = None
    for k0 in range(0, a.shape[-1], 16):
        step = _rz(a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double())
        acc = step if acc is None else acc + step
    return acc


def _in_order(a, b):
    """a @ b summed d = 0, 1, ... in f32, one rounding a term."""
    import torch

    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i in range(a.shape[-1]):
        acc = acc + a[..., i:i + 1] * b[..., i:i + 1, :]
    return acc


def _ambiguous(f, a):
    """attn::ambiguous: whether f lies within 64 f32 ulps, or within
    2^-20 a, of a bf16 rounding midpoint."""
    import torch

    u = f.view(torch.int32)
    low = (u & 0xffff) - 0x8000
    mid = ((u & -65536) | 0x8000).view(torch.float32)
    return (low.abs() < 64) | ((f - mid).abs() <= a * 2.0 ** -20)


def _sum_rn(t):
    """K22's l and c: a row's f32 terms summed in float64, rounded once
    to f32."""
    import torch

    return t.double().sum(-1, keepdim=True).to(torch.float32)


def _bf16(t):
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


def attention_scores_mma(qkv, scale, fold_scale=False):
    """s (N, H, S, S), the row max, e and l as K18 and K22 compute them:
    the f32 dot of bf16 q . k, then `* scale` in f32; with `fold_scale`,
    q * scale rounded to bf16 first and no scale after the dot (the
    counterfactual the kernels do not take)."""
    import torch

    q, k = (qkv[:, :, i].to(torch.float32).permute(0, 2, 1, 3)
            for i in range(2))
    if fold_scale:
        s = _tc_rn(_bf16(q * scale), k.transpose(-1, -2))
    else:
        s = _tc_rn(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return s, m, e, e.sum(-1, keepdim=True)


def attention_mma(qkv, scale, fold_scale=False):
    """K18's arithmetic: p = bf16(e / l), o = the sum of bf16 p . bf16 v
    in the accumulator, 16 keys at a time, rounded to bf16; (N, S, H * D)
    like `attention_plain`."""
    import torch

    n, s_, _, h, d = qkv.shape
    _s, _m, e, l = attention_scores_mma(qkv, scale, fold_scale)
    p = _bf16(e / l)
    v = qkv[:, :, 2].to(torch.float32).permute(0, 2, 1, 3)
    o = _tc([p], v)
    return o.permute(0, 2, 1, 3).reshape(n, s_, h * d).to(torch.bfloat16)


def attention_backward_mma(qkv, do, scale, terms=2):
    """K22's arithmetic: dP = do . v as the scores are summed, the values
    whose bf16 rounding that leaves ambiguous (against |do| . |v|) summed
    again in order, rounded to bf16; c and dS in f32 at the reference's
    rounding points, dq = dS . k and dk = dS^T . q with dS given to the
    tensor cores as `terms` bf16 values, one product each into one
    accumulator (K22 takes 2: hi = bf16(dS) and lo = bf16(dS - hi); 1, a
    single bf16 dS, is the counterfactual), dv = p^T . do; each rounded to
    bf16. (N, S, 3, H, D) like `attention_backward_plain`."""
    import torch

    n, s_, _, h, d = qkv.shape
    q, k, v = (qkv[:, :, i].to(torch.float32).permute(0, 2, 1, 3)
               for i in range(3))
    g = do.reshape(n, s_, h, d).to(torch.float32).permute(0, 2, 1, 3)
    _s, _m, e, _l = attention_scores_mma(qkv, scale)
    l = _sum_rn(e)
    p = _bf16(e / l)
    vt = v.transpose(-1, -2)
    dp = _tc_rn(g, vt)
    amb = _ambiguous(dp, _tc([g.abs()], vt.abs()))
    dp = _bf16(torch.where(amb, _in_order(g, vt), dp))
    c = _sum_rn((dp * (l * l).reciprocal()) * e)
    ds = ((dp / l) + -c) * e * scale
    parts, rest = [], ds
    for _ in range(terms):
        parts.append(_bf16(rest))
        rest = rest - parts[-1]
    dq = _tc(parts, k)
    dk = _tc([a.transpose(-1, -2) for a in parts], q)
    dv = _tc([p.transpose(-1, -2)], g)
    return torch.stack([dq, dk, dv], 1).permute(0, 3, 1, 2, 4).to(
        torch.bfloat16)


def repeated_index_wires(seed: int, n: int = 3, bh: int = 2, bw: int = 3):
    """Hand-made upload wires whose entries repeat indices (runs of zero
    gaps, the index-0 clamp, duplicate sorted indices), each upload's
    arguments as `_jit_batch_graph` takes them for one component of (n,
    bh, bw, 64): {"sparse": (idx, val), "int8": (c8, idx, val), "gap8":
    (g, v, ci, cv), "gap4": (prim, sg, sv, ci, cv)} as numpy arrays. A
    packer writes no such wire; a restore must still add every entry, as
    the reference's scatter-adds do."""
    rng = np.random.default_rng(seed)
    m = bh * bw * 64

    def gaps(k):
        """Gaps of 0-2 (0 first in some rows: the clamp), zeroed where
        the running sum would pass the plane."""
        g = rng.integers(0, 3, (n, k))
        g[:, 0] = rng.integers(0, 2, n)
        return np.where(np.cumsum(g, 1) <= m, g, 0).astype(np.uint8)

    def vals(shape, lo=-20, hi=21):
        return rng.integers(lo, hi, shape)

    k = 3 * m // 4
    idx = np.sort(rng.integers(0, m, (n, k)), 1).astype(np.int32)
    kc = 40
    ci = np.sort(rng.integers(0, n * m, kc)).astype(np.int32)
    ci[1] = ci[0]
    cv = vals(kc, -900, 900).astype(np.int16)
    prim = (gaps(k).astype(np.int32) << 4 | rng.integers(0, 16, (n, k)))
    return {
        "sparse": (idx, vals((n, k)).astype(np.int16)),
        "int8": (vals((n, bh, bw, 64), -128, 128).astype(np.int8), ci, cv),
        "gap8": (gaps(k), vals((n, k), -128, 128).astype(np.int8), ci, cv),
        "gap4": (prim.astype(np.uint8), gaps(k // 4),
                 vals((n, k // 4), -128, 128).astype(np.int8), ci, cv),
    }


def gap4_indices(gaps):
    """(N, k) gaps -> (N, k) int64 indices, cumsum - 1 clamped at 0."""
    return np.maximum(np.cumsum(gaps.astype(np.int64), 1) - 1, 0)


def gap4_within(prim, sg, sv, m: int):
    """The gap4 wire with every entry at an index past the plane (m)
    turned into a no-op (gap 0, value 0): K30 drops such entries, and the
    plain version then gives what K30 gives (it would add them into the
    next image's plane, or past the batch)."""
    prim, sg, sv = prim.copy(), sg.copy(), sv.copy()
    past = gap4_indices(prim >> 4) >= m
    prim[past] = 0x07
    past = gap4_indices(sg) >= m
    sg[past] = 0
    sv[past] = 0
    return prim, sg, sv


def gap4_packed_wire(seed, n: int, bh: int, bw: int):
    """n sparse int16 planes (mostly zeros, escapes past 7 and past int8)
    through the numpy packer: (prim, sg, sv, ci, cv) as the upload holds
    them. `seed`: an int or a numpy Generator."""
    rng = np.random.default_rng(seed)
    m = bh * bw * 64
    planes = np.zeros((n, m), np.int16)
    for i in range(n):
        nz = rng.random(m) < rng.uniform(0.05, 0.3)
        planes[i, nz] = rng.integers(-6, 7, int(nz.sum()))
        big = rng.random(m) < 0.01
        planes[i, big] = rng.integers(-400, 400, int(big.sum()))
    from picha_tpu_torch.ops.coef_host import gap4_pack_batch

    _k1, _k2, _kc, prim, sg, sv, ci, cv = gap4_pack_batch(
        [p.reshape(bh, bw, 64) for p in planes])
    return prim, sg, sv, ci, cv


def gap4_tile_wires(seed: int, tile: int):
    """Gap4 wires (K30's upload) that cross many tiles of `tile` entries:
    {name: (prim, sg, sv, ci, cv, bh, bw)} as numpy arrays, of 3 images
    each. "packed": the numpy packer's wire of sparse planes; "zero_runs":
    runs of zero gaps with nonzero values across every tile boundary;
    "empty_image": one image all padding; "short_image": one that ends
    before its plane does; "past_m": indices past the plane (dropped);
    "boundary_escapes": side-stream values and corrections at the cells
    where tiles begin; "no_primary": an empty primary stream (k1 = 0)."""
    rng = np.random.default_rng(seed)
    n = 3
    bw = 5
    bh = max(1, -(-40 * tile // (64 * bw)))
    m = bh * bw * 64
    out = {"packed": gap4_packed_wire(rng, n, bh, bw) + (bh, bw)}
    prim, sg, sv, ci, cv = gap4_packed_wire(rng, n, bh, bw)
    k1 = prim.shape[1]

    def codes(shape):
        return rng.integers(0, 16, shape).astype(np.uint8)

    z = prim.copy()
    for t in range(tile, k1, tile):
        lo, hi = max(t - 3, 0), min(t + 3, k1)
        z[:, lo:hi] = codes((n, hi - lo)) & 15        # gap 0
    z = gap4_within(z, sg, sv, m)[0]
    out["zero_runs"] = (z, sg, sv, ci, cv, bh, bw)
    e = prim.copy()
    e[1] = 0x07
    out["empty_image"] = (e, sg, sv, ci, cv, bh, bw)
    sh = prim.copy()
    run = np.cumsum(sh[2] >> 4)
    sh[2, run >= m // 2] = 0x07
    out["short_image"] = (sh, sg, sv, ci, cv, bh, bw)
    pm = prim.copy()
    pm[0, k1 // 3:] = (15 << 4) | codes(k1 - k1 // 3)
    sg_pm = sg.copy()
    sg_pm[0] = np.maximum(sg_pm[0], 200)
    out["past_m"] = (pm, sg_pm, sv, ci, cv, bh, bw)
    # side entries at the first cell of each primary tile
    firsts = gap4_indices(prim >> 4)[:, ::tile]
    k2 = firsts.shape[1]
    bsg = np.zeros((n, k2), np.uint8)
    bsv = rng.integers(-128, 128, (n, k2)).astype(np.int8)
    for i in range(n):
        prev = 0
        for j, c in enumerate(firsts[i]):
            step = int(c) + 1 - prev
            if 0 <= step <= 255:
                bsg[i, j], prev = step, int(c) + 1
            else:
                bsv[i, j] = 0
    bci = (np.arange(n)[:, None] * m + firsts).reshape(-1).astype(np.int32)
    bcv = rng.integers(-900, 900, bci.size).astype(np.int16)
    esc = prim.copy()
    esc[:, ::tile] = (esc[:, ::tile] & 0xF0) | 15
    out["boundary_escapes"] = (esc, bsg, bsv, np.concatenate([ci, bci]),
                               np.concatenate([cv, bcv]), bh, bw)
    out["no_primary"] = (np.zeros((n, 0), np.uint8), sg, sv, ci, cv, bh, bw)
    return out


def gap8_within(g, v, m: int):
    """The gap8 wire with every entry at an index past the plane (m)
    turned into a no-op (gap 0, value 0): K29 drops such entries (the
    plain version would add them into the next image's plane)."""
    g, v = g.copy(), v.copy()
    past = gap4_indices(g) >= m
    g[past] = 0
    v[past] = 0
    return g, v


def gap8_packed_wire(seed, n: int, bh: int, bw: int, density=(0.05, 0.3)):
    """n sparse int16 planes (values past int8 among them) through the
    numpy packer, padded and stacked as `stack_bucket` stacks them: (g
    (n, k) u8, v (n, k) i8, ci (kc,) i32 batch-flat, cv (kc,) i16).
    `seed`: an int or a numpy Generator."""
    rng = np.random.default_rng(seed)
    m = bh * bw * 64
    from picha_tpu_torch.ops.coef_host import gap8_pack_plain

    packed = []
    for _ in range(n):
        plane = np.zeros(m, np.int16)
        nz = rng.random(m) < rng.uniform(*density)
        plane[nz] = rng.integers(-6, 7, int(nz.sum()))
        big = rng.random(m) < density[0] / 5
        plane[big] = rng.integers(-400, 400, int(big.sum()))
        packed.append(gap8_pack_plain(plane))
    k = max(p[0].size for p in packed)
    g = np.zeros((n, k), np.uint8)
    v = np.zeros((n, k), np.int8)
    for j, (gj, vj, _ci, _cv) in enumerate(packed):
        g[j, :gj.size], v[j, :vj.size] = gj, vj
    ci = np.concatenate([p[2].astype(np.int64) + j * m
                         for j, p in enumerate(packed)]).astype(np.int32)
    cv = np.concatenate([p[3] for p in packed]).astype(np.int16)
    return g, v, ci, cv


def gap8_tile_wires(seed: int, tile: int):
    """Gap8 wires (K29's upload) that cross many tiles of `tile` entries:
    {name: (g, v, ci, cv, bh, bw)} as numpy arrays, of 3 images each.
    "packed": the numpy packer's wire of sparse planes; "zero_runs": runs
    of zero gaps with nonzero values across every tile boundary (repeated
    indices); "gap255": a plane so sparse that chains of gap-255 entries
    (value 0) cross several tiles; "empty_image": one image all padding;
    "short_image": one that ends before its plane does; "past_m":
    indices past the plane (dropped); "boundary_corrections": corrections
    at the cells where tiles begin."""
    rng = np.random.default_rng(seed)
    n, bw = 3, 5
    bh = max(1, -(-40 * tile // (64 * bw)))
    m = bh * bw * 64
    g, v, ci, cv = gap8_packed_wire(rng, n, bh, bw)
    k = g.shape[1]
    out = {"packed": (g, v, ci, cv, bh, bw)}
    z, zv = g.copy(), v.copy()
    for t in range(tile, k, tile):
        lo, hi = max(t - 3, 0), min(t + 3, k)
        z[:, lo:hi] = 0
        zv[:, lo:hi] = rng.integers(1, 100, (n, hi - lo))
    out["zero_runs"] = gap8_within(z, zv, m) + (ci, cv, bh, bw)
    sbh = max(1, -(-8 * tile * 255 // (64 * bw)))
    sg, sv, sci, scv = gap8_packed_wire(rng, n, sbh, bw, (0.0001, 0.0003))
    out["gap255"] = (sg, sv, sci, scv, sbh, bw)
    e, ev = g.copy(), v.copy()
    e[1], ev[1] = 0, 0
    keep = (ci < m) | (ci >= 2 * m)
    out["empty_image"] = (e, ev, ci[keep], cv[keep], bh, bw)
    sh, shv = g.copy(), v.copy()
    run = np.cumsum(sh[2].astype(np.int64))
    sh[2, run >= m // 2], shv[2, run >= m // 2] = 0, 0
    out["short_image"] = (sh, shv, ci, cv, bh, bw)
    pm = g.copy()
    pm[0, k // 3:] = np.maximum(pm[0, k // 3:], 200)
    out["past_m"] = (pm, v, ci, cv, bh, bw)
    firsts = gap4_indices(g)[:, ::tile]
    bci = (np.arange(n)[:, None] * m + np.minimum(firsts, m - 1)).reshape(
        -1).astype(np.int32)
    bcv = rng.integers(-900, 900, bci.size).astype(np.int16)
    out["boundary_corrections"] = (g, v, np.concatenate([ci, bci]),
                                   np.concatenate([cv, bcv]), bh, bw)
    return out


RESTORE_SENTINEL = -(2 ** 40)


def tiled_restore_model(pg, pval, sg, sv, ci, cv, m, tile, cells,
                        vec=True):
    """The tiled restore of K29 and K30 (`csrc/coef_restore.cu`: the
    *_tile_sums, *_write and *_adds kernels) on numpy arrays: the primary
    stream's gaps `pg` and values `pval` ((n, k1) each), a gap8 side
    stream (sg, sv) ((n, k2); K29 has none: k2 = 0) and the batch-flat
    corrections -> ((n, m) int64 planes, (n, m) count of the owned-range
    writes of each cell). The output starts as a sentinel: every cell
    the owned ranges miss keeps it."""
    n, k1 = pg.shape
    k2 = sg.shape[1]
    tp, ts = max(1, -(-k1 // tile)), -(-k2 // tile)
    out = np.full((n, m), RESTORE_SENTINEL, np.int64)
    writes = np.zeros((n, m), np.int64)
    # gap4_tile_sums
    pg = pg.astype(np.int64)
    pval = pval.astype(np.int64)
    psum = np.zeros((n, tp), np.int64)
    ssum = np.zeros((n, max(ts, 1)), np.int64)
    for t in range(tp):
        psum[:, t] = pg[:, t * tile:(t + 1) * tile].sum(1)
    for t in range(ts):
        ssum[:, t] = sg[:, t * tile:(t + 1) * tile].astype(np.int64).sum(1)
    # gap4_write
    spills = []
    for img in range(n):
        for t in range(tp):
            base = int(psum[img, :t].sum())
            j = np.arange(t * tile, min((t + 1) * tile, k1))
            g = pg[img, j]
            val = pval[img, j]
            idx = np.maximum(base + np.cumsum(g) - 1, 0)
            total = int(g.sum())
            lo = 0 if t == 0 else max(base + int(pg[img, t * tile]) - 1, 0)
            hi = m if t + 1 == tp else max(
                base + total + int(pg[img, (t + 1) * tile]) - 1, 0)
            lo, hi = min(lo, m), min(hi, m)
            assert not (idx < lo).any(), "an entry before its tile's cells"
            for c0 in range(lo, hi, cells):
                c1 = min(c0 + cells, hi)
                cb = c0 & ~3
                buf = np.zeros(-(-(c1 - cb) // 4) * 4, np.int64)
                inside = (val != 0) & (idx >= c0) & (idx < c1)
                np.add.at(buf, idx[inside] - cb, val[inside])
                a = (c0 + 3) & ~3 if vec else c1
                e = c1 & ~3 if vec else c1
                if a >= e:
                    a = e = c1
                assert a % 4 == 0 or a == c1
                for c in list(range(c0, a)) + list(range(e, c1)):
                    out[img, c] = buf[c - cb]
                    writes[img, c] += 1
                for q in range(a, e, 4):       # one 16-byte store
                    out[img, q:q + 4] = buf[q - cb:q - cb + 4]
                    writes[img, q:q + 4] += 1
            past = (idx >= hi) & (idx < m)
            assert (idx[past] == hi).all()
            spills.append((img * m + hi if hi < m else -1,
                           int(val[past].sum())))
    flat = out.reshape(-1)
    # gap4_adds: side tiles, spills, corrections
    for img in range(n):
        for t in range(ts):
            base = int(ssum[img, :t].sum())
            j = np.arange(t * tile, min((t + 1) * tile, k2))
            idx = np.maximum(base + np.cumsum(sg[img, j].astype(np.int64))
                             - 1, 0)
            v = sv[img, j].astype(np.int64)
            keep = (v != 0) & (idx < m)
            np.add.at(flat, img * m + idx[keep], v[keep])
    for cell, v in spills:
        if v and cell >= 0:
            flat[cell] += v
    keep = (cv != 0) & (ci >= 0) & (ci < n * m)
    np.add.at(flat, ci[keep].astype(np.int64), cv[keep].astype(np.int64))
    return out, writes


# --- K25 / K26: numpy models of the kernels' arithmetic -----------------------
# (csrc/resnet_norm.cuh, resnet_norm.cu, resnet_norm_bwd.cu): the same cut of
# each plane into clusters, rows and chunks, the same f32 and float64
# roundings, in the same order. They run here, where no kernel does.

NORM_THREADS = 256     # a plane kernel's block
NORM_CHUNK = 8         # pixels a thread sums in f32 before float64


def norm_plan(hw: int, c: int, vector_width: int = 8):
    """(tp, rows, cl) of a plane kernel: threads across a pixel, rows of a
    block, CTAs of a cluster (`threads_per_pixel`, `cluster_size`)."""
    tp = 32
    if vector_width == 8:
        tp = 1
        while tp < 32 and tp * 8 < c:
            tp *= 2
    rows = NORM_THREADS // tp
    cl = min(8, max(1, -(-hw // (64 * rows))))
    return tp, rows, cl


def _f32(a):
    return np.asarray(a, np.float32)


def _tree(v):
    """A warp's xor-shuffle butterfly over its rows (axis 0, a power of
    two): pairs, then pairs of pairs, in float64."""
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def norm_plane_sums(terms, hw: int, c: int, vector_width: int = 8):
    """The plane kernels' float64 (Q, C) sums in the kernel's order: f32
    over NORM_CHUNK rows a thread, float64 over the thread's chunks, a
    shuffle tree over a warp's rows, the warps in order, the cluster's
    ranks in order. `terms(px0, px1)` gives a rank's Q quantities for its
    pixels: an (L, C) float32 array is added, a pair (a, b) accumulates
    a * b with one rounding (fmaf)."""
    tp, rows, cl = norm_plan(hw, c, vector_width)
    per_warp = max(1, 32 // tp)
    total = None
    for r in range(cl):
        block = []
        for term in terms(hw * r // cl, hw * (r + 1) // cl):
            pair = isinstance(term, tuple)
            parts = term if pair else (term,)
            length = parts[0].shape[0]
            chunks = -(-(-(-length // rows)) // NORM_CHUNK)
            padded = []
            for v in parts:
                pad = np.zeros((chunks * NORM_CHUNK * rows, c), np.float32)
                pad[:length] = v
                padded.append(pad.reshape(chunks, NORM_CHUNK, rows, c))
            acc = np.zeros((chunks, rows, c), np.float32)
            for u in range(NORM_CHUNK):
                if pair:
                    acc = _f32(acc.astype(np.float64) + padded[0][:, u]
                               .astype(np.float64) * padded[1][:, u])
                else:
                    acc = _f32(acc + padded[0][:, u])
            s = np.zeros((rows, c))
            for j in range(chunks):
                s = s + acc[j].astype(np.float64)
            warps = s.reshape(rows // per_warp, per_warp, c)
            t = _tree(warps[0])
            for w in range(1, warps.shape[0]):
                t = t + _tree(warps[w])
            block.append(t)
        block = np.stack(block)
        total = block if total is None else total + block
    return total


def _exact(f):
    from fractions import Fraction

    return Fraction(float(f))


def k25_stats_model(x, vector_width: int = 8):
    """K25's mu and sigma, (N, C) float32, of x (N, H, W, C): bf16 values
    as float32 numpy."""
    n, h, w, c = x.shape
    hw = h * w
    mu = np.zeros((n, c), np.float32)
    sigma = np.zeros((n, c), np.float32)
    for i in range(n):
        flat = x[i].reshape(hw, c).astype(np.float32)
        s1, s2 = norm_plane_sums(
            lambda a, b: [flat[a:b], (flat[a:b], flat[a:b])], hw, c,
            vector_width)
        for ch in range(c):
            mu[i, ch], sigma[i, ch] = _finish_stats(s1[ch], s2[ch], hw)
    return mu, sigma


def _finish_stats(s1, s2, hw):
    """K25's finish_plane: mu = f32(S1) / hw; the sum of (x - mu)^2 as
    (hw S2 - S1^2 + (S1 - hw mu)^2) / hw with exact two-products."""
    hwf = np.float32(hw)
    mu = np.float32(np.float32(s1) / hwf)
    n = float(hw)
    a = n * s2
    a_lo = float(_exact(n) * _exact(s2) - _exact(a))
    b = s1 * s1
    b_lo = float(_exact(s1) * _exact(s1) - _exact(b))
    nm2 = (a - b) + (a_lo - b_lo)
    e = float(_exact(s1) - _exact(n) * _exact(mu))
    q = float(_exact(e) * _exact(e) + _exact(nm2)) / n
    if q < 0:
        q = 0.0
    var = np.float32(np.float32(q) / hwf)
    return mu, np.sqrt(np.float32(var + np.float32(1e-5)))


def relu_open_bound(sigma, scale):
    """K26's open_bound: (N, C) float32, NaN where the exact path always
    runs (scale 0 or NaN, or the bound not finite)."""
    a = np.abs(scale.astype(np.float64))[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = sigma.astype(np.float64) * np.maximum(2.0 ** -99,
                                                  2.0 ** -109 / a)
    tf = t.astype(np.float32)
    low = tf.astype(np.float64) < t            # round up (__double2float_ru)
    tf[low] = np.nextafter(tf[low], np.float32(np.inf))
    bad = ~(a > 0) | ~np.isfinite(tf)
    return np.where(np.broadcast_to(bad, tf.shape), np.float32(np.nan), tf)


def relu_open_model(p, sigma, scale, bound):
    """K26's mask (masked_dy) on (N, HW, C) float32 p = x - mu: the sign test at
    |p| >= bound, else bf16(((p / sigma) * scale)) > 0 in f32."""
    import torch

    r = sigma[:, None, :]
    sc = scale[None, None, :]
    with np.errstate(all="ignore"):
        fast = np.abs(p) >= bound[:, None, :]
        w = _f32(_f32(p / r) * sc)
    exact = torch.from_numpy(w).to(torch.bfloat16).float().numpy() > 0
    return np.where(fast, (p > 0) == (sc > 0), exact)


def k26_model(x, dy, scale, mu, sigma, vector_width: int = 8):
    """K26's dx (float32 before its bf16 rounding) and dscale (float32)
    from numpy x, dy (N, H, W, C: bf16 values as float32), scale (C,),
    mu, sigma (N, C) float32."""
    n, h, w, c = x.shape
    hw = h * w
    hwf = np.float32(hw)
    bound = relu_open_bound(sigma, scale)
    dx = np.zeros((n, hw, c), np.float32)
    terms = np.zeros((n, c))
    for i in range(n):
        xi = x[i].reshape(hw, c).astype(np.float32)
        p = _f32(xi - mu[i])
        g = np.where(relu_open_model(p[None], sigma[i:i + 1], scale,
                                     bound[i:i + 1])[0],
                     dy[i].reshape(hw, c), np.float32(0))
        sums = norm_plane_sums(lambda a, b: [p[a:b], g[a:b], (g[a:b], p[a:b])],
                               hw, c, vector_width)
        r = sigma[i]
        u = _f32(np.float32(1) / _f32(r * r))
        a = _f32(u.astype(np.float64) * scale.astype(np.float64) * sums[2])
        dvar = _f32(-a * _f32(np.float32(0.5) / r))
        dvar_hw = _f32(dvar / hwf)
        b = _f32(-(scale.astype(np.float64) * sums[1]) / r.astype(np.float64))
        by = -_f32(dvar_hw * _f32(np.float32(2) * _f32(sums[0])))
        dmu = _f32(_f32(b + by) / hwf)
        terms[i] = sums[2] / r.astype(np.float64)
        gr = _f32(_f32(g * scale) / r)
        bv = _f32(dvar_hw * _f32(np.float32(2) * p))
        dx[i] = _f32(_f32(gr + bv) + dmu)
    dscale = np.zeros(c)
    for i in range(n):
        dscale = dscale + terms[i]
    return dx.reshape(x.shape), dscale.astype(np.float32)


def k17_lane_model(x, scale, bias):
    """K17's tuned kernel (even d <= 1024) in numpy float32, in its exact
    order: lane L of a row's warp sums its pairs p = L + 32 i in i order
    (x, then y), the 32 lane sums meet in the xor-shuffle tree (lane L
    adds lane L ^ o's sum, o = 16, 8, 4, 2, 1), mu and var are true
    divisions by d, den an IEEE square root of var + 1e-6, then (v / den)
    * scale + bias, each step rounded to float32, and one rounding to
    bf16 (nearest even) at the end. x: (..., d) bf16 torch tensor;
    scale, bias (d,) float32. Returns a bf16 torch tensor on the CPU."""
    import torch

    d = x.shape[-1]
    pairs = d // 2
    assert d % 2 == 0 and d <= 1024
    xs = x.detach().cpu().to(torch.float32).numpy().reshape(-1, pairs, 2)
    rows = xs.shape[0]
    slots = -(-pairs // 32)
    f32 = np.float32

    def lane_sums(t):
        # t: (rows, pairs, 2) float32 -> the tree's result, per row
        s = np.zeros((rows, 32), f32)
        for i in range(slots):
            for lane in range(32):
                p = lane + 32 * i
                if p < pairs:
                    s[:, lane] = (s[:, lane] + t[:, p, 0]) + t[:, p, 1]
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, np.arange(32) ^ o]
        assert (s == s[:, :1]).all() or np.isnan(s).any()
        return s[:, 0, None, None]

    n = f32(d)
    v = xs - lane_sums(xs) / n
    den = np.sqrt(lane_sums(v * v) / n + f32(1e-6))
    sc = np.asarray(scale.detach().cpu(), f32).reshape(pairs, 2)
    bi = np.asarray(bias.detach().cpu(), f32).reshape(pairs, 2)
    out = (v / den) * sc + bi
    assert out.dtype == np.float32
    return torch.from_numpy(out.reshape(x.shape)).to(torch.bfloat16)


def k8_tile_model(x, base, windows, plan, in_scale, out_scale):
    """K8's one-launch kernel (`csrc/resize_axis.cu::resize_2d`) as numpy
    float32 steps over its tiles, for a plan of `ops.resize.resize_plan`:
    each tile's source spans from the min / max of its starts, every
    source row of the tile staged as the 16-byte words that cover its
    column span (the row's first element lands at its address's offset
    in the word, `base` being x's offset in elements from a 16-byte
    aligned address), the width pass of each staged row read from the
    stage (v * in_scale per tap), the f32 intermediate in a (rows_max,
    tx * c) array whose unused cells are NaN, the height pass in float4
    quads, stores of the valid outputs only. Words past the tensor are
    NaN, and the output starts as NaN, so a wrong index or a missed store
    shows. x: (n, h, w, c) uint8 or float32 numpy; windows: ((sw, tw),
    (sh, th)) numpy. Returns float32 (n, dst_h, dst_w, c)."""
    f32 = np.float32
    (sw, tw), (sh, th) = windows
    n, h, w, c = x.shape
    eb = x.dtype.itemsize
    dst_w, kw = tw.shape
    dst_h, kh = th.shape
    tx, ty, rows_max, chunks = (plan[k] for k in ("tx", "ty", "rows_max",
                                                  "span_chunks"))
    per_word = 16 // eb
    flat = x.reshape(-1).astype(f32) * f32(in_scale)
    out = np.full((n, dst_h, dst_w, c), np.nan, f32)
    for ni in range(n):
        for oy0 in range(0, dst_h, ty):
            for ox0 in range(0, dst_w, tx):
                nx, ny = min(tx, dst_w - ox0), min(ty, dst_h - oy0)
                xlo = int(sw[ox0:ox0 + nx].min())
                xcnt = (int(sw[ox0:ox0 + nx].max()) + kw - xlo) * c
                ylo = int(sh[oy0:oy0 + ny].min())
                rows = int(sh[oy0:oy0 + ny].max()) + kh - ylo
                assert rows <= rows_max and 15 + xcnt * eb <= 16 * chunks
                mid = np.full((rows_max, tx * c), np.nan, f32)
                col = np.arange(nx * c)
                ox, ch = col // c, col % c
                base_col = (sw[ox0 + ox] - xlo) * c + ch
                wts = tw[ox0 + ox]                          # (nx * c, kw)
                for r in range(rows):
                    e0 = ((ni * h + ylo + r) * w + xlo) * c
                    shift = ((base + e0) * eb % 16) // eb
                    nc = (shift * eb + xcnt * eb + 15) // 16
                    stage = np.full(chunks * per_word, np.nan, f32)
                    lo = e0 - shift
                    a, b = max(lo, 0), min(lo + nc * per_word, flat.size)
                    stage[a - lo:b - lo] = flat[a:b]
                    acc = np.zeros(nx * c, f32)
                    for j in range(kw):
                        acc = acc + wts[:, j] * stage[shift + base_col + j * c]
                    mid[r, :nx * c] = acc
                for oy in range(ny):
                    rel = int(sh[oy0 + oy]) - ylo
                    acc = np.zeros(tx * c, f32)
                    for j in range(kh):
                        acc = acc + th[oy0 + oy, j] * mid[rel + j]
                    acc = acc * f32(out_scale)
                    out[ni, oy0 + oy, ox0:ox0 + nx] = \
                        acc[:nx * c].reshape(nx, c)
    return out


def k3_synthetic_blocks(kind: str, n: int, h: int, w: int, c: int,
                        seed: int):
    """(N, bh, bw, 64) int16 natural-order planes of the 4:2:0 (or grey)
    encode of an h x w image, as numpy: `zeros` all zero (EOB only);
    `zrl` sparse AC with runs of 15-48 zeros (ZRLs) and the last
    position set in some blocks; `size11` +-2047 and +-1024 among small
    values (DC diffs past 2047 capped like the reference's); `ff` dense
    positive 2^s - 1 values (codes and value bits of ones: many 0xFF
    bytes)."""
    from picha_tpu_torch.ops.jpeg_scan import ZIGZAG
    from picha_tpu_torch.ops.jpeg_write import resized_comp_sig

    rng = np.random.default_rng(seed)
    zz = np.asarray(ZIGZAG)
    out = []
    for bh, bw, _hs, _vs in resized_comp_sig(h, w, c):
        z = np.zeros((n, bh, bw, 64), np.int64)   # zigzag order
        if kind == "zrl":
            z[..., 0] = rng.integers(-300, 300, (n, bh, bw))
            for k in (1, 17, 18, 34, 51, 63):
                z[..., k] = rng.choice([0, 0, 3, -5, 1], (n, bh, bw))
            z[..., 33] = rng.choice([0, 7], (n, bh, bw))
        elif kind == "size11":
            z[...] = rng.choice([0, 0, 0, 0, 1, -1, 2047, -2047, 1024, -1024,
                                 3], (n, bh, bw, 64))
            z[..., 0] = rng.choice([2047, -2047, 0, 5], (n, bh, bw))
        elif kind == "ff":
            vals = np.array([(1 << s) - 1 for s in range(1, 11)] + [0] * 6)
            z[...] = rng.choice(vals, (n, bh, bw, 64))
        elif kind != "zeros":
            raise ValueError(kind)
        nat = np.zeros_like(z)
        nat[..., zz] = z
        out.append(nat.astype(np.int16))
    return tuple(out)


def k2_samples_model(f255: np.ndarray):
    """K2's load and convert (csrc/jpeg_encode_front.cu) in numpy: units
    (MCUs of 16x16 pixels at 4:2:0, 8x8 blocks for grey) in raster order
    over the batch, in tiles of 16 (96) units; each unit's rows loaded
    with the row clamped to the image and the columns past it left
    unloaded (NaN, so that a read of one fails); Y from each pixel with
    its column clamped to the unit's last loaded one, Cb and Cr from each
    2x2 quad with the chroma row and column clamped to the plane's
    last, then the pixels' columns. Returns the per-component (N, bh,
    bw, 64) int sample blocks (before the -128), every block written
    once (-1: none)."""
    from picha_tpu_torch.ops.jpeg import FIX

    n, h, w, c = f255.shape
    colour = c == 3
    side = 16 if colour else 8
    per_tile = 16 if colour else 96
    uh, uw = -(-h // side), -(-w // side)
    ybh, ybw = -(-h // 8), -(-w // 8)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    out = [np.full((n, ybh, ybw, 64), -1, np.int64)]
    if colour:
        out += [np.full((n, uh, uw, 64), -1, np.int64) for _ in range(2)]
    total = n * uh * uw
    tiles = -(-total // per_tile)
    for q in range(tiles * per_tile):
        if q >= total:
            continue
        ni, rem = divmod(q, uh * uw)
        uy, ux = divmod(rem, uw)
        vy, vx = min(side, h - side * uy), min(side, w - side * ux)
        raw = np.full((side, side, c), np.nan, np.float32)
        for r in range(side):
            y = side * uy + min(r, vy - 1)
            raw[r, :vx] = f255[ni, y, side * ux:side * ux + vx]

        def px(r, col):
            v = raw[r, col]
            assert not np.isnan(v).any(), "read of an unloaded column"
            return np.floor(np.clip(v + np.float32(0.5), 0, 255)).astype(
                np.int64)

        if not colour:
            blk = [int(px(r, min(x, vx - 1))[0]) for r in range(8)
                   for x in range(8)]
            assert (out[0][ni, uy, ux] == -1).all()
            out[0][ni, uy, ux] = blk
            continue
        for r in range(16):
            for x in range(16):
                rr, gg, bb = px(r, min(x, vx - 1))
                yv = (FIX(0.29900) * rr + FIX(0.58700) * gg
                      + FIX(0.11400) * bb + 32768) >> 16
                by, bx = 2 * uy + (r >> 3), 2 * ux + (x >> 3)
                if by < ybh and bx < ybw:
                    out[0][ni, by, bx, (r & 7) * 8 + (x & 7)] = yv
        bias = (128 << 16) + 32768 - 1
        for cr in range(8):
            for cc in range(8):
                r0 = 2 * min(cr, ch - 8 * uy - 1)
                c0 = 2 * min(cc, cw - 8 * ux - 1)
                sb = sr = 0
                for dy in range(2):
                    for dx in range(2):
                        rr, gg, bb = px(r0 + dy, min(c0 + dx, vx - 1))
                        sb += (-FIX(0.16874) * rr - FIX(0.33126) * gg
                               + FIX(0.50000) * bb + bias) >> 16
                        sr += (FIX(0.50000) * rr - FIX(0.41869) * gg
                               - FIX(0.08131) * bb + bias) >> 16
                out[1][ni, uy, ux, cr * 8 + cc] = (sb + 2) >> 2
                out[2][ni, uy, ux, cr * 8 + cc] = (sr + 2) >> 2
    return tuple(out)


def _bitsize(x: int) -> int:
    return min(abs(x).bit_length(), 11)


def _low_bits(x: int, s: int) -> int:
    return (x - 1 if x < 0 else x) & ((1 << s) - 1)


def k3_block_packets(blk, prev_dc: int, dummy: bool, t: int, tab):
    """One scan block's packets as K3 walks them: the DC diff's, then for
    each set bit of the zigzag nonzero mask its ZRLs and its own, then
    the EOB unless position 63 is set. blk: (64,) natural order."""
    from picha_tpu_torch.ops.jpeg_scan import ZIGZAG

    zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
    diff = 0 if dummy else zz[0] - prev_dc
    s = _bitsize(diff)
    cl = int(tab[t, s])
    out = [(((cl & 0xFFFF) << s) | _low_bits(diff, s), (cl >> 16) + s)]
    ac = tab[2 + t]
    zrl, eob = int(ac[0xF0]), int(ac[0])
    pk = 0
    for k in ([] if dummy else [k for k in range(1, 64) if zz[k]]):
        run, v = k - pk - 1, zz[k]
        sz = _bitsize(v)
        out += [(zrl & 0xFFFF, zrl >> 16)] * (run >> 4)
        c2 = int(ac[((run & 15) << 4) | sz])
        out.append((((c2 & 0xFFFF) << sz) | _low_bits(v, sz),
                    (c2 >> 16) + sz))
        pk = k
    if pk != 63:
        out.append((eob & 0xFFFF, eob >> 16))
    return out


def k3_scan_model(planes, gidx, dummy, tid, prev, tab, byte_cap: int,
                  tile: int = 256, chunk: int = 4096):
    """K3's two phases (csrc/huffman_encode_scan.cu) in numpy, image by
    image. Bits: tiles of `tile` scan blocks, each block's offset in its
    tile by an exclusive scan, each tile's offset in the image by the sum
    of the earlier tiles (what the look-back returns); the tile's words
    assembled at that alignment (a block's first and last word ORed, the
    words between stored into zeros), stored into a buffer of
    ceil(byte_cap / 4) words rounded up to 4 (past it dropped), a word
    shared by two tiles formed from both tiles' halves; the last tile
    pads with 1-bits. Stuffing: chunks of `chunk` raw bytes covering
    byte_cap, each counting its 0xFF among the first min(nraw, byte_cap)
    bytes, laid out with a 0x00 after each, and its output range (data,
    then zeros up to the next chunk's) written into `out`. Asserts that
    every word and byte is written as the kernels write it (each word
    once, a boundary word from exactly two halves; every byte of out
    once). Returns (out (N, byte_cap) uint8, nbytes
    (N,) int64)."""
    n_img = planes[0].shape[0]
    flat = np.concatenate([p.reshape(n_img, -1, 64) for p in planes], 1)
    nblk = len(gidx)
    nwords = -(-(-(-byte_cap // 4)) // 4) * 4
    out = np.zeros((n_img, byte_cap), np.uint8)
    nbytes = np.zeros(n_img, np.int64)
    for ni in range(n_img):
        pk = [k3_block_packets(flat[ni, gidx[j]],
                               0 if prev[j] < 0 else
                               int(flat[ni, gidx[prev[j]], 0]),
                               bool(dummy[j]), int(tid[j]), tab)
              for j in range(nblk)]
        lens = [sum(ln for _p, ln in b) for b in pk]
        words = [None] * nwords       # None: never written
        halves = {}                   # word -> the two tiles' parts
        base = 0
        tiles = -(-nblk // tile)
        for u in range(tiles):
            blocks = range(u * tile, min(nblk, (u + 1) * tile))
            total = sum(lens[j] for j in blocks)
            pad = (-(base + total)) % 8 if u == tiles - 1 else 0
            sh = base % 32
            seg = [0] * ((sh + total + pad + 31) // 32)
            stored = [False] * len(seg)
            off = sh
            for j in blocks:
                packets = pk[j] + ([((1 << pad) - 1, pad)]
                                   if j == nblk - 1 else [])
                acc, nb, wi, first = 0, off % 32, off // 32, True
                for p, ln in packets:
                    assert 0 <= p < (1 << ln) or (p == 0 and ln == 0)
                    acc, nb = (acc << ln) | p, nb + ln
                    if nb >= 32:
                        word = (acc >> (nb - 32)) & 0xFFFFFFFF
                        if first:
                            seg[wi] |= word
                        else:
                            assert seg[wi] == 0 and not stored[wi]
                            seg[wi], stored[wi] = word, True
                        first, wi, nb = False, wi + 1, nb - 32
                        acc &= (1 << nb) - 1
                if nb:
                    seg[wi] |= (acc << (32 - nb)) & 0xFFFFFFFF
                off += lens[j] + (pad if j == nblk - 1 else 0)
            w0 = base // 32
            tail = u < tiles - 1 and (base + total) % 32 != 0
            for i, word in enumerate(seg):
                if (i == 0 and sh) or (i == len(seg) - 1 and tail):
                    halves.setdefault(w0 + i, []).append(word)
                elif w0 + i < nwords:
                    assert words[w0 + i] is None
                    words[w0 + i] = word
            base += total + pad
        for w, parts in halves.items():
            assert len(parts) == 2
            if w < nwords:
                assert words[w] is None
                words[w] = parts[0] | parts[1]
        nraw = base // 8
        lim = min(nraw, byte_cap)
        assert all(wd is not None for wd in words[:-(-lim // 4)])
        raw = np.array([((wd or 0) >> s) & 0xFF for wd in words
                        for s in (24, 16, 8, 0)], np.uint8)
        written = np.zeros(byte_cap, np.int64)
        shift = 0
        for u in range(-(-byte_cap // chunk)):
            data = raw[u * chunk:max(u * chunk, min(lim, (u + 1) * chunk))]
            ff = np.flatnonzero(data == 0xFF)
            ob = np.zeros(chunk + len(ff), np.uint8)
            ob[:len(data) + len(ff)] = np.insert(data, ff + 1, 0)
            start = u * chunk + shift
            keep = np.arange(start, start + ob.size) < byte_cap
            out[ni, start:start + ob.size][:int(keep.sum())] = ob[keep]
            np.add.at(written, np.arange(start, start + ob.size)[keep], 1)
            shift += len(ff)
        assert (written == 1).all()
        nbytes[ni] = nraw + shift
    return out, nbytes
