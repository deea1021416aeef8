"""Regenerate the port's 1080p corpora and their strict host-path
references (run from the repository root):

    python tests/fixtures/port/make_fixtures.py

src_<i>.jpg: 1920x1088 synthetic images made as bench.py's
make_test_images does (seed 42), encoded by libjpeg at q85, decoded and
re-encoded at q85 with a restart marker every 8 MCUs (bench.py's
device-roofline corpus prep).
src_nr_<i>.jpg: the same decoded pixels encoded at q85 without restart
markers. Restart markers change only the entropy stage, so the
coefficients equal src_<i>.jpg's and ref_<i>.jpg is their strict-host
output too.
ref_<i>.jpg: the strict host path on each (libjpeg decode -> native
resize to 960x544 -> libjpeg encode q85), the <=1 LSB parity anchor
for machines without the native library.
raw420_inputs.npz, raw420_<case>.jpg: the host JPEG writer's anchor
(`host_writer_cases`): seeded 4:2:0 planes and coefficient sets at odd
sizes and two qualities, and what libjpeg (native.jpeg_encode_raw420,
native.jpeg_coef_write) writes of them.
"""
import pathlib
import sys

import numpy as np

N_IMAGES = 3
W, H, OUT_W, OUT_H, QUALITY, RESTART = 1920, 1088, 960, 544, 85, 8


def make_sources(n: int, seed: int = 42):
    """(restart-8 encodes, restart-free encodes) of the same n images."""
    from picha_tpu.native import lib as native

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    noise = rng.normal(0, 6, (H, W, 3)).astype(np.float32)
    rst, flat = [], []
    for i in range(n):
        fx, fy = rng.uniform(1, 6, 2)
        base = (127 + 60 * np.sin(2 * np.pi * fx * xx / W + i)
                + 50 * np.cos(2 * np.pi * fy * yy / H))
        img = np.stack([base, np.roll(base, 37, axis=1),
                        np.roll(base, 71, axis=0)], axis=-1)
        arr = np.clip(img + np.roll(noise, i * 13, axis=1), 0,
                      255).astype(np.uint8)
        pixels = native.jpeg_decode(native.jpeg_encode(arr, QUALITY), 3, W, H)
        rst.append(native.jpeg_encode(pixels, QUALITY, restart=RESTART))
        flat.append(native.jpeg_encode(pixels, QUALITY))
    return rst, flat


# case -> (kind, (height, width), quality); kind "raw420" (padded 4:2:0
# planes), "coef3" (4:2:0 coefficient planes) or "coef1" (grey)
HOST_WRITER_CASES = {
    "planes_q50": ("raw420", (37, 45), 50),
    "planes_q95": ("raw420", (33, 31), 95),
    "coef3_q50": ("coef3", (17, 100), 50),
    "coef1_q95": ("coef1", (33, 31), 95),
}


def host_writer_inputs(seed: int = 7):
    """case -> {array name: array}: seeded planes (smooth waves plus
    noise) or coefficient planes (a decaying spectrum of small integers)
    for each of HOST_WRITER_CASES."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (kind, (h, w), _q) in HOST_WRITER_CASES.items():
        if kind == "raw420":
            hp, wp = (h + 15) & ~15, (w + 15) & ~15
            planes = {}
            for key, (ph, pw) in (("y", (hp, wp)), ("cb", (hp // 2, wp // 2)),
                                  ("cr", (hp // 2, wp // 2))):
                yy, xx = np.mgrid[0:ph, 0:pw]
                base = 128 + 70 * np.sin(xx / rng.uniform(2, 6) + yy / 5.0)
                planes[key] = np.clip(base + rng.normal(0, 12, (ph, pw)), 0,
                                      255).astype(np.uint8)
            out[name] = planes
        else:
            cdiv = lambda a, b: -(-a // b)  # noqa: E731
            grids = ([(cdiv(h, 8), cdiv(w, 8))] if kind == "coef1" else
                     [(cdiv(h, 8), cdiv(w, 8))]
                     + [(cdiv(cdiv(h, 2), 8), cdiv(cdiv(w, 2), 8))] * 2)
            scale = 60.0 / (1.0 + np.arange(64))
            out[name] = {f"c{i}": np.round(rng.laplace(
                0, 1, (bh, bw, 64)) * scale).astype(np.int16)
                for i, (bh, bw) in enumerate(grids)}
    return out


def host_writer_jpeg(name, arrays):
    """libjpeg's bytes for one host-writer case."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops.jpeg_tpu import quality_tables

    kind, (h, w), q = HOST_WRITER_CASES[name]
    if kind == "raw420":
        return bytes(native.jpeg_encode_raw420(
            arrays["y"], arrays["cb"], arrays["cr"], w, h, q))
    ql, qc = quality_tables(q)
    if kind == "coef1":
        comps = [{"coefs": arrays["c0"], "qtable": ql, "h_samp": 1,
                  "v_samp": 1}]
    else:
        comps = [{"coefs": arrays[f"c{i}"], "qtable": ql if i == 0 else qc,
                  "h_samp": 2 if i == 0 else 1, "v_samp": 2 if i == 0 else 1}
                 for i in range(3)]
    return bytes(native.jpeg_coef_write(w, h, comps))


def write_host_writer_fixtures(here: pathlib.Path):
    inputs = host_writer_inputs()
    np.savez(here / "raw420_inputs.npz",
             **{f"{name}.{k}": v for name, arrs in inputs.items()
                for k, v in arrs.items()})
    for name, arrs in inputs.items():
        buf = host_writer_jpeg(name, arrs)
        (here / f"raw420_{name}.jpg").write_bytes(buf)
        print(f"raw420_{name}.jpg {len(buf)} B")


def main():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))
    from picha_tpu.pipeline import JpegBatchPipeline

    here = pathlib.Path(__file__).resolve().parent
    srcs, flat = make_sources(N_IMAGES)
    refs = JpegBatchPipeline(width=OUT_W, height=OUT_H,
                             encode_quality=QUALITY,
                             encode_backend="host").host_encode_batch(srcs)
    for i, (s, f, r) in enumerate(zip(srcs, flat, refs)):
        (here / f"src_{i}.jpg").write_bytes(bytes(s))
        (here / f"src_nr_{i}.jpg").write_bytes(bytes(f))
        (here / f"ref_{i}.jpg").write_bytes(bytes(r))
        print(f"src_{i}.jpg {len(s)} B, src_nr_{i}.jpg {len(f)} B, "
              f"ref_{i}.jpg {len(r)} B")
    write_host_writer_fixtures(here)


if __name__ == "__main__":
    main()
