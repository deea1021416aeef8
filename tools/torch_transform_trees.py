#!/usr/bin/env python3
"""Time the port's PNG and TIFF transform kernels (K14, K16) and its TIFF
LZW kernel (K15) of several checkouts in turns on one CUDA card.

    python3 tools/torch_transform_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, on
BASELINE config 4's buckets (256 images of 384x256, the same in every
run), reports per bucket: a digest of the kernel's output bits, whether
they equal the plain version's, the kernel's CUDA-event time (median of
3 rounds of 20 launches), a `clone()` of the input where the kernel is
the identity, the bound (bytes in and out at 3.35 TB/s) and, where the
checkout has `kernel_info`, the build of the kernel the bucket launches.
K14 / K16 run on seeded random bytes. K15 runs on the LZW strips of TIFF
files that Pillow writes from config 4's seeded sources (8 images tiled
to 256): as they are, with predictor 2 and orientation 6, and made
compressible (no noise, 8 levels a channel); its digest covers (rows,
out_len, status), its plain version runs on the first 2 images' strips,
and `one_strip_ms` is one launch on the bucket's longest strip alone
(the serial chain a strip cannot beat). Prints the card's name and power
limit, then one JSON line a run; with --json, also writes them all to
OUT.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

N, W, H = 256, 384, 256        # BASELINE config 4's 256 sources
HBM_BYTES_S = 3.35e12          # H100 SXM, 700 W


def timed(fn, reps=20, rounds=3):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return sorted(out)[len(out) // 2]


def digest(t):
    return hashlib.sha256(t.contiguous().view(-1).view(
        __import__("torch").uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def buckets(dev):
    """name -> (kernel fn, plain fn, identity input or None, bytes, info
    args): config 4's rgba TIFF bucket (predictor 1, orientation 1; also
    on a view at byte offset 5), its predictor-2 orientation-6 bucket,
    the rgba PNG bucket, the palette + tRNS PNG bucket (tables as views
    at odd offsets) and the 16-bit rgb PNG decoded deep."""
    import numpy as np
    import torch

    from picha_tpu_torch.ops import png_transform as k14
    from picha_tpu_torch.ops import tiff_transform as k16

    rng = np.random.default_rng(14)
    rb = W * 4
    flat = torch.from_numpy(rng.integers(0, 256, N * H * rb + 16,
                                         np.uint8)).to(dev)
    rows = flat[:N * H * rb].view(N, H, rb)
    rows5 = flat[5:5 + N * H * rb].view(N, H, rb)
    s11 = (W, H, 4, 8, 2, 1, 1, "<", True)
    s26 = (W, H, 4, 8, 2, 2, 6, "<", True)
    rgba = rows.view(N, H, W, 4)
    idx = torch.from_numpy(rng.integers(0, 256, (N, H, W, 1), np.uint8)).to(dev)
    tab = torch.from_numpy(rng.integers(0, 256, N * 1024 + 8, np.uint8)).to(dev)
    pal = tab[3:3 + N * 768].view(N, 256, 3)
    trns = tab[3 + N * 768 + 2:3 + N * 768 + 2 + N * 256].view(N, 256)
    deep = torch.from_numpy(rng.integers(0, 256, (N, H, W, 6), np.uint8)).to(dev)
    nb = rows.numel()
    return {
        "tiff rgba8 p1 o1": (lambda: k16.tiff_transform(rows, s11),
                             lambda: k16.tiff_transform_plain(rows, s11),
                             rows, 2 * nb, ("tiff", s11)),
        "tiff rgba8 p1 o1 at byte offset 5": (
            lambda: k16.tiff_transform(rows5, s11),
            lambda: k16.tiff_transform_plain(rows5, s11), rows5, 2 * nb,
            ("tiff", s11)),
        "tiff rgba8 p2 o6": (lambda: k16.tiff_transform(rows, s26),
                             lambda: k16.tiff_transform_plain(rows, s26),
                             None, 2 * nb, ("tiff", s26)),
        "png rgba8 to rgba": (
            lambda: k14.png_transform(rgba, 6, 8, "rgba"),
            lambda: k14.png_transform_plain(rgba, 6, 8, "rgba"), rgba,
            2 * nb, ("png", (6, 8, "rgba"))),
        "png palette + tRNS to rgba": (
            lambda: k14.png_transform(idx, 3, 8, "rgba", pal, trns),
            lambda: k14.png_transform_plain(idx, 3, 8, "rgba", pal, trns),
            None, idx.numel() * 5 + pal.numel() + trns.numel(),
            ("png", (3, 8, "rgba"))),
        "png rgb16 to r16g16b16 (deep)": (
            lambda: k14.png_transform(deep, 2, 16, "r16g16b16"),
            lambda: k14.png_transform_plain(deep, 2, 16, "r16g16b16"), None,
            2 * deep.numel(), ("png", (2, 16, "r16g16b16"))),
    }


def config4_tiffs(kind):
    """chip_smoke.py's config-4 sources (seed 9; 8 images) as Pillow
    TIFF-LZW files, tiled to N: "plain", "p2o6" (predictor 2, orientation
    6) or "compressible" (no noise term, quantised to 8 levels a
    channel)."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(9)
    files = []
    for i in range(8):
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        base = 127 + 70 * np.sin(xx / (11 + i)) + 40 * np.cos(yy / (7 + i))
        a = np.stack([base, 255 - base, base * 0.5 + 60,
                      np.full_like(base, 255) - (xx + yy) % 17], -1)
        if kind != "compressible":
            a = a + rng.normal(0, 4, (H, W, 4))
        a = np.clip(a, 0, 255).astype(np.uint8)
        if kind == "compressible":
            a = a // 32 * 32
        out = io.BytesIO()
        Image.fromarray(a, "RGBA").save(
            out, "TIFF", compression="tiff_lzw",
            tiffinfo={317: 2, 274: 6} if kind == "p2o6" else {})
        files.append(out.getvalue())
    return [files[i % 8] for i in range(N)]


def lzw_buckets(dev):
    """name -> (segs, (4, K) strip table, rows shape, strips of the first
    2 images) on `dev`, from the checkout's own host stage and pack."""
    from picha_tpu_torch.codecs import tiff_host
    from picha_tpu_torch.pipeline import tiff_batch
    from picha_tpu_torch.runtime import upload

    out = {}
    for kind in ("plain", "p2o6", "compressible"):
        items = [tiff_host.host_stage(b) for b in config4_tiffs(kind)]
        host, lay = tiff_batch.pack(items)
        buf = upload(host, dev)
        table = buf[:lay.segs].view(__import__("torch").int64).view(
            4, lay.nstrips)
        sig = items[0].sig
        rb = (sig[0] * sig[2] * sig[3] + 7) // 8
        out[f"lzw {kind}"] = (buf[lay.segs:lay.rows], table, (N, sig[1], rb),
                              sum(len(it.strips) for it in items[:2]))
    return out


def run_lzw(res, dev):
    """K15 on the three LZW buckets into res; True when every bucket
    equals the plain version on its first 2 images."""
    import torch

    from picha_tpu_torch.ops import lzw

    ok = True
    for name, (segs, table, shape, k2) in lzw_buckets(dev).items():
        rows = torch.zeros(shape, dtype=torch.uint8, device=dev)

        def fn(rows=rows, segs=segs, table=table):
            return lzw.lzw_decode(segs, table[0], table[1], rows, table[2],
                                  table[3])

        n, st = fn()
        torch.cuda.synchronize()
        rows_p = torch.zeros((2,) + shape[1:], dtype=torch.uint8)
        tab_c = table[:, :k2].cpu()
        n_p, st_p = lzw.lzw_decode(segs.cpu(), tab_c[0], tab_c[1], rows_p,
                                   tab_c[2], tab_c[3])
        equal = bool(torch.equal(rows[:2].cpu(), rows_p)
                     and torch.equal(n[:k2].cpu(), n_p)
                     and torch.equal(st[:k2].cpu(), st_p))
        longest = int(torch.argmax(table[1]))
        one = table[:, longest:longest + 1].contiguous()
        nbytes = segs.numel() + rows.numel()
        res[name] = {
            "bits": digest(torch.cat([rows.view(-1), n.view(torch.uint8),
                                      st.view(torch.uint8)])),
            "equal_to_plain": equal, "ms": timed(fn),
            "one_strip_ms": timed(lambda: lzw.lzw_decode(
                segs, one[0], one[1], rows, one[2], one[3])),
            "strips": int(table.shape[1]), "segment_bytes": segs.numel(),
            "failed_strips": int(st.sum()),
            "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bytes": nbytes,
            "build": lzw.kernel_info() if hasattr(lzw, "kernel_info")
            else "not in this checkout"}
        ok = ok and equal and res[name]["failed_strips"] == 0
    return ok


def info(kind, args):
    from picha_tpu_torch.ops import png_transform as k14
    from picha_tpu_torch.ops import tiff_transform as k16

    mod = k16 if kind == "tiff" else k14
    if not hasattr(mod, "kernel_info"):
        return "not in this checkout"
    return mod.kernel_info(args) if kind == "tiff" else mod.kernel_info(*args)


def run(label):
    """One checkout, imported from the working directory."""
    import torch

    from picha_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    dev = torch.device("cuda", 0)
    for name, (fn, plain, ident, nbytes, inf) in buckets(dev).items():
        got = fn()
        torch.cuda.synchronize()
        r = {"bits": digest(got), "equal_to_plain": bool(torch.equal(
            got.cpu(), plain().cpu())), "ms": timed(fn),
             "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bytes": nbytes,
             "build": info(*inf)}
        if ident is not None:
            r["identity"] = bool(torch.equal(got.view(-1), ident.reshape(-1)))
            r["clone_ms"] = timed(ident.clone)
        res[name] = r
    lzw_ok = run_lzw(res, dev)
    print("RESULT " + json.dumps(res), flush=True)
    return 0 if lzw_ok and all(v["equal_to_plain"] for k, v in res.items()
                               if isinstance(v, dict)) else 1


def main(argv):
    if len(argv) == 3 and argv[1] == "--run":
        return run(argv[2])
    out = None
    if len(argv) > 2 and argv[1] == "--json":
        out, argv = pathlib.Path(argv[2]).resolve(), argv[2:]
    trees = [a.split("=", 1) for a in argv[1:]]
    if not trees or any(len(t) != 2 for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    runs, failed = [], False
    for label, path in trees:
        root = pathlib.Path(path).resolve()
        p = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--run",
             label], cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
            capture_output=True, text=True, timeout=1200)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            failed = True
            print(label, "failed", p.returncode, p.stdout[-2000:],
                  p.stderr[-4000:], flush=True)
            if not line:
                continue
        runs.append(json.loads(line[0][7:]))
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
