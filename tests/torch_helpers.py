"""Shared inputs for the port's tests (tests/test_torch_*.py).

The same numpy inputs go to picha_tpu (JAX on the CPU) and to
picha_tpu_torch. The 1080p restart-8 corpus under fixtures/port/ is
the main path's input on machines without the native library
(fixtures/port/make_fixtures.py regenerates it).
"""
import pathlib

import numpy as np

PORT_FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "port"
N_FIXTURES = 3


def port_corpus(n: int = 16):
    """n 1920x1088 q85 restart-8 JPEGs: the committed sources, tiled."""
    srcs = [(PORT_FIXTURES / f"src_{i}.jpg").read_bytes()
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


def scan_batch_inputs(bufs, device="cpu"):
    """JPEG bytes (or parsed ScanInfos) -> (ScanBatch, scan key, port
    DecoderArgs, qtabs, comp_of tensor) with the wire on `device`."""
    import torch

    from picha_tpu.ops import jpeg_scan
    from picha_tpu.ops.jpeg_huffman_decode_tpu import ScanBatch
    from picha_tpu_torch.ops.jpeg_huffman_decode import wire_unpack

    infos = [b if isinstance(b, jpeg_scan.ScanInfo)
             else jpeg_scan.parse_baseline(bytes(b)) for b in bufs]
    assert all(i is not None for i in infos)
    sb = ScanBatch(infos)
    ks, wire = sb.wire()
    args, qtabs = wire_unpack(torch.from_numpy(wire).to(device), ks,
                              infos[0].ncomp)
    comp_of = torch.as_tensor(sb.comp_of, dtype=torch.int32, device=device)
    return sb, ks, args, qtabs, comp_of
