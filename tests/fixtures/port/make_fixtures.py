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


if __name__ == "__main__":
    main()
