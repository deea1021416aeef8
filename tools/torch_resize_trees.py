#!/usr/bin/env python3
"""Time the port's resize (K8) of several checkouts in turns on one CUDA
card.

    python3 tools/torch_resize_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, on
seeded inputs at three shapes of the main paths:

  transcode  16 x 1088 x 1920 x 3 uint8 -> 544 x 960, cubic 0.7 (the
             staged JPEG transcode's resize, out_scale 255; 5 taps);
  ingest_h   256 x 192 x 224 x 3 float32 -> 224 rows, cubic 1.0 (the
             training ingest's height pass, K8-H);
  config4    256 x 224 x 352 x 4 float32 -> 112 x 176, cubic 0.7
             (BASELINE config 4's crop_resize_map; 5 taps);

at the training ingest's crop (`ingest_crop`: 256 x 1088 x 1920 x 3
uint8 frames with seeded corners, some past the frame's edges, and
flips -> crops of 192 -> 224 x 224, cubic 1.0: K9 + K8's height pass,
and the checkout's `crop_flip_resize` where it has one, also launched at
each tile height ty of 64-2), and at three of
`resize_batch`'s (float32 after K11's unpack) with other
window lengths than 5: up_k4 (16 x 272 x 480 x 3 -> 544 x 960, cubic, 4
taps), down_k7 (16 x 1088 x 1920 x 3 -> 544 x 960, cubic, 7 taps) and
down_k9 (the same, lanczos, 9 taps),

reports: a digest of the output's bits (which must match across
checkouts) and whether it equals the windowed twins
(`resize_axis_windowed_plain` once an axis, on the card); CUDA-event
medians of `resize_windowed` (both axes: the checkout's route), of the
per-axis width and height passes (`resize_axis`) and of the two in a
row (`per_axis_ms`); the call's
kernels by name (torch.profiler); the bounds (bytes over 3.35 TB/s:
input and output once for both axes; each pass's own input and output
for the per-axis passes); `ops.resize.kernel_info` where the checkout
has it, and `nvcc -Xptxas -v` of the checkout's `resize_axis.cu`.
Prints the card's name and power limit, then one JSON line a run; with
--json, also writes them all to OUT.
"""
import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

HBM = 3.35e12
# name -> (n, src_h, src_w, c, dtype, dst_h, dst_w, filter, fscale,
#          out_scale); dst_w None: the height pass alone
SHAPES = {
    "transcode": (16, 1088, 1920, 3, "uint8", 544, 960, "cubic", 0.7, 255.0),
    "ingest_h": (256, 192, 224, 3, "float32", 224, None, "cubic", 1.0, 1.0),
    "config4": (256, 224, 352, 4, "float32", 112, 176, "cubic", 0.7, 1.0),
    "up_k4": (16, 272, 480, 3, "float32", 544, 960, "cubic", 1.0, 1.0),
    "down_k7": (16, 1088, 1920, 3, "float32", 544, 960, "cubic", 1.0, 1.0),
    "down_k9": (16, 1088, 1920, 3, "float32", 544, 960, "lanczos", 1.0,
                1.0),
}
# the ingest's crop: frames (n, h, w, 3) uint8, crop, size, filter, fscale
INGEST_CROP = (256, 1088, 1920, 192, 224, "cubic", 1.0)


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


def by_kernel(fn, reps=10):
    """Device ms and launches a call of fn, by kernel name
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        if us:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name)[0].split()[-1].split("::")[-1]
            # builds of one kernel (template arguments) add up
            row = rows.setdefault(name, {"ms": 0.0, "launches": 0.0})
            row["ms"] += us / 1e3 / reps
            row["launches"] += e.count / reps
            # the profiler may miss a launch of the window: ms a launch
            row["ms_a_launch"] = row["ms"] / row["launches"]
    return rows


def ptxas(root, source):
    """Registers, stack, spill and shared bytes of every kernel of one
    source of the checkout (`nvcc -Xptxas -v`)."""
    from picha_tpu_torch.kernels import _build

    p = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull,
         str(root / "picha_tpu_torch" / "csrc" / source)],
        capture_output=True, text=True, timeout=600)
    out, cur = {}, None
    for line in (p.stdout + p.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out[cur].update(registers=int(m.group(1)),
                            smem=int(m.group(2) or 0))
    return out


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()) \
        .hexdigest()[:16]


def inputs(n, h, w, c, dtype, dev):
    import torch

    g = torch.Generator().manual_seed(n + h + w + c)
    if dtype == "uint8":
        x = torch.randint(0, 256, (n, h, w, c), generator=g,
                          dtype=torch.uint8)
    else:
        x = torch.rand((n, h, w, c), generator=g)
    return x.to(dev)


def ty_sweep(rs, x, xs, ys, flip, crop, windows, want):
    """K9's one launch at each tile height ty (the plan's tx; its source
    rows and shared bytes recomputed for that ty as `resize_plan` makes
    them): CUDA-event ms, blocks an SM, and the output's equality with
    `want`."""
    import torch

    from picha_tpu_torch.kernels._build import KERNELS, ptr, stream_of

    (sw, tw), (sh, th) = windows
    hw, hh = rs.starts_host(sw)[0], rs.starts_host(sh)[0]
    kw, kh = tw.shape[1], th.shape[1]
    base = rs.windowed_plan(x, windows, crop=True)
    n, h, w, c = x.shape
    tx, chunks = base["tx"], base["span_chunks"]
    out = torch.empty_like(want)
    res = {}
    for ty in (64, 48, 32, 16, 8, 4, 2):
        ylo, yhi = rs.tile_spans(hh, kh, ty)
        rows = int((yhi - ylo).max())
        smem = rows * chunks * 16 + 4 * (rows * tx * c + tx * kw + ty * kh
                                         + tx + ty + rows)

        def call():
            KERNELS["crop_flip_resize"](
                ptr(x), n, h, w, c, ptr(xs), ptr(ys), ptr(flip), crop,
                th.shape[0], tw.shape[0], ptr(sw), ptr(tw), kw, ptr(sh),
                ptr(th), kh, rs.INV255, ptr(out), tx, ty, rows, chunks, smem,
                stream_of(x))

        call()
        res[ty] = dict(rows=rows, smem=smem, equal=bool(torch.equal(out,
                                                                    want)),
                       ms=timed(call),
                       blocks_an_sm=rs.card_info(x.device, 3, 1, c, max(kw, kh),
                                                 smem)["blocks_an_sm"])
    return res


def ingest_crop(rs, dev):
    """The training ingest's crop + flip + resize on seeded frames,
    corners and flips: K9 then K8's height pass (`crop_flip_resize_w`,
    `resize_axis`), and the one-launch `crop_flip_resize` where the
    checkout has it; both held to the plain chain (`flipped_crops`, then
    the windowed twin on each axis)."""
    import torch

    n, h, w, crop, size, filt, fs = INGEST_CROP
    x = inputs(n, h, w, 3, "uint8", dev)
    g = torch.Generator().manual_seed(23)
    xs = torch.randint(-8, w - crop + 9, (n,), generator=g,
                       dtype=torch.int32)
    ys = torch.randint(-8, h - crop + 9, (n,), generator=g,
                       dtype=torch.int32)
    flip = torch.rand(n, generator=g) < 0.5
    xs, ys, flip = xs.to(dev), ys.to(dev), flip.to(dev)
    win = rs.window_tensors(size, crop, filt, fs, dev)
    windows = (win, win)
    (sw, tw), (sh, th) = windows

    def chain():
        return rs.resize_axis(rs.crop_flip_resize_w(x, xs, ys, flip, crop,
                                                    sw, tw), sh, th, -3)

    got = chain()
    want = rs.resize_axis_windowed_plain(rs.resize_axis_windowed_plain(
        rs.flipped_crops(x, xs, ys, flip, crop), sw, tw, -2), sh, th, -3)
    r = dict(shape=[n, h, w, 3], crop=crop, size=size, taps=tw.shape[1],
             flips=int(flip.sum()), out=list(got.shape), bits=digest(got),
             equal_to_twins=bool(torch.equal(got, want)))
    r["per_axis_ms"] = timed(chain)
    r["per_axis_by_kernel"] = by_kernel(chain)
    r["width_ms"] = timed(lambda: rs.crop_flip_resize_w(x, xs, ys, flip,
                                                        crop, sw, tw))
    mid = rs.crop_flip_resize_w(x, xs, ys, flip, crop, sw, tw)
    r["height_ms"] = timed(lambda: rs.resize_axis(mid, sh, th, -3))
    crops_bytes = n * crop * crop * 3
    r["bound_ms"] = (crops_bytes + got.numel() * 4) / HBM * 1e3
    r["per_axis_bound_ms"] = (crops_bytes + 2 * mid.numel() * 4
                              + got.numel() * 4) / HBM * 1e3
    if hasattr(rs, "crop_flip_resize"):
        def fused():
            return rs.crop_flip_resize(x, xs, ys, flip, crop, windows)

        one = fused()
        r["fused_bits"] = digest(one)
        r["fused_equal_to_twins"] = bool(torch.equal(one, want))
        r["fused_ms"] = timed(fused)
        r["fused_by_kernel"] = by_kernel(fused)
        r["fused_info"] = rs.crop_kernel_info(x, crop, windows)
        r["fused_ty_sweep"] = ty_sweep(rs, x, xs, ys, flip, crop, windows,
                                       one)
        del one
    del x, got, want, mid
    torch.cuda.empty_cache()
    return r


def run(label):
    """One checkout, imported from the working directory."""
    import torch

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.ops import resize as rs

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "shapes": {}}
    for name, (n, h, w, c, dt, dh, dw, filt, fs, osc) in SHAPES.items():
        x = inputs(n, h, w, c, dt, dev)
        sh = rs.window_tensors(dh, h, filt, fs, dev)
        r = dict(shape=[n, h, w, c], dtype=dt, out_scale=osc,
                 taps_h=sh[1].shape[1])
        if dw is None:
            got = rs.resize_axis(x, *sh, -3, osc)
            want = rs.resize_axis_windowed_plain(x, *sh, -3, osc)
            r.update(out=list(got.shape), bits=digest(got),
                     equal_to_twins=bool(torch.equal(got, want)))
            r["height_ms"] = timed(lambda: rs.resize_axis(x, *sh, -3, osc))
            r["height_by_kernel"] = by_kernel(
                lambda: rs.resize_axis(x, *sh, -3, osc))
            r["height_bound_ms"] = (x.numel() * x.element_size()
                                    + got.numel() * 4) / HBM * 1e3
        else:
            sw = rs.window_tensors(dw, w, filt, fs, dev)
            win = (sw, sh)
            got = rs.resize_windowed(x, win, osc)
            xw = rs.resize_axis(x, *sw, -2)
            want = rs.resize_axis_windowed_plain(
                rs.resize_axis_windowed_plain(x, *sw, -2), *sh, -3, osc)
            r.update(out=list(got.shape), taps_w=sw[1].shape[1],
                     bits=digest(got),
                     equal_to_twins=bool(torch.equal(got, want)))
            r["resize_ms"] = timed(lambda: rs.resize_windowed(x, win, osc))
            r["resize_by_kernel"] = by_kernel(
                lambda: rs.resize_windowed(x, win, osc))
            r["resize_bound_ms"] = (x.numel() * x.element_size()
                                    + got.numel() * 4) / HBM * 1e3
            r["per_axis_ms"] = timed(lambda: rs.resize_axis(
                rs.resize_axis(x, *sw, -2), *sh, -3, osc))
            r["width_ms"] = timed(lambda: rs.resize_axis(x, *sw, -2))
            r["width_bound_ms"] = (x.numel() * x.element_size()
                                   + xw.numel() * 4) / HBM * 1e3
            r["height_ms"] = timed(lambda: rs.resize_axis(xw, *sh, -3, osc))
            r["height_bound_ms"] = (xw.numel() * 4 + got.numel() * 4) \
                / HBM * 1e3
            if hasattr(rs, "kernel_info"):
                r["kernel_info"] = rs.kernel_info(x, win)
            del xw
        res["shapes"][name] = r
        del x, got, want
        torch.cuda.empty_cache()
    res["shapes"]["ingest_crop"] = ingest_crop(rs, dev)
    res["ptxas"] = ptxas(pathlib.Path.cwd(), "resize_axis.cu")
    print("RESULT " + json.dumps(res), flush=True)


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
    runs, failed, first = [], False, {}
    for label, path in trees:
        root = pathlib.Path(path).resolve()
        with tempfile.TemporaryDirectory() as tmp:
            p = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--run", label], cwd=root,
                env=dict(os.environ, PYTHONPATH=str(root), TMPDIR=tmp),
                capture_output=True, text=True, timeout=1200)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            failed = True
            print(label, "failed", p.returncode, p.stdout[-2000:],
                  p.stderr[-4000:], flush=True)
            continue
        runs.append(json.loads(line[0][7:]))
        bits = {k: v["bits"] for k, v in runs[-1]["shapes"].items()}
        if "fused_bits" in runs[-1]["shapes"]["ingest_crop"]:
            bits["ingest_crop_fused"] = \
                runs[-1]["shapes"]["ingest_crop"]["fused_bits"]
        first = first or dict(label=label, bits=bits)
        # the fused crop must give the per-axis chain's bits
        same = {k: v == first["bits"].get(
            "ingest_crop" if k == "ingest_crop_fused" else k)
            for k, v in bits.items()}
        runs[-1]["same_bits_as_first_run"] = dict(label=first["label"],
                                                  **same)
        failed |= not all(same.values())
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
