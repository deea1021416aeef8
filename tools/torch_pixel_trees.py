#!/usr/bin/env python3
"""Time the port's PNG encode filters (K12) and the ingest's clip +
augment (K10) of several checkouts in turns on one CUDA card.

    python3 tools/torch_pixel_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and
reports, on seeded inputs (the same in every run):

  K12  at config 4's encoded batch (256 x 112 rows of 704 bytes, bpp 4),
       at 8 x 1080p RGB8 (5,760-byte rows, bpp 3) and at 4 x 1080 rows
       of 16-bit RGBA 1920 wide (15,360 bytes, bpp 8): the default
       probe's three candidate streams as `png_batch.filter_candidates`
       makes them (the parent: three launches; one launch where the
       checkout has `filter_streams`), timed from the rows (and
       `candidates_ms`: the pipeline's call, with its 16-bit byte
       split), and each single stream (-1, 1, 2 at config 4, -1
       elsewhere) through `filter_batch`;
  K10  at the ingest's batch (256 x 224 x 224 x 3 float32 in [-0.05,
       1.05], as a resize leaves it) with brightness, contrast and
       saturation 0.2 and a 32-pixel cutout, and with contrast off
       (`clone_ms`: a copy of the batch, the card's streaming rate);

each with a digest of the output bits, equality with the plain version
(K12 bit for bit; K10 within 1e-6, and bit for bit the plain chain on
the lane model's mean where the checkout has `augment_sum_lanes`), a
repeat's equality, CUDA-event ms (median of 3 rounds of 20 calls), the
call's kernels by name (torch.profiler), the bound (bytes read once and
written once over 3.35 TB/s) and `kernel_info` where the checkout has
it. Then the device-only time beside the call time of K20, K23 and K24
at the MoE ViT-S forward's shapes (t = 50,176, E = 4, d = 384) and of
K11's head and tail at config 4's call, and `nvcc -Xptxas -v` of the
checkout's `png_filter.cu` and `augment.cu`. Prints the card's name and
power limit, then one JSON line a run; with --json, also writes them
all to OUT. The main process checks K12's and K10's digests against the
first run's.
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
AUGMENT = {"brightness_s": .2, "contrast_s": .2, "saturation_s": .2,
           "cutout_size": 32}
NO_CONTRAST = {"brightness_s": .2, "saturation_s": .2, "cutout_size": 32}
# name -> (images, rows, width, channels, dtype, single strategies)
K12_SHAPES = {"config4": (256, 112, 176, 4, "uint8", (-1, 1, 2)),
              "rgb8_1080p": (8, 1080, 1920, 3, "uint8", (-1,)),
              "rgba16_1920": (4, 1080, 1920, 4, "uint16", (-1,))}
K10_SHAPE = (256, 224, 224)


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
    (torch.profiler; memsets under their own name)."""
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
            if not name.startswith("Memset"):
                name = re.split(r"[(<]", name)[0].split()[-1].split("::")[-1]
            row = rows.setdefault(name, {"ms": 0.0, "launches": 0.0})
            row["ms"] += us / 1e3 / reps
            row["launches"] += e.count / reps
    if rows:
        rows["sum_ms"] = sum(v["ms"] for v in rows.values())
    return rows or "not measured"


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


def digest(*ts):
    import torch

    h = hashlib.sha256()
    for t in ts:
        t = t.contiguous()
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pixels(n, h, w, c, dtype, seed):
    """Seeded photo-like pixels: per-image gradients and bands with a
    little noise, so the adaptive pick varies from row to row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    top = 65535 if dtype == "uint16" else 255
    yy = np.arange(h, dtype=np.float32)[:, None, None]
    xx = np.arange(w, dtype=np.float32)[None, :, None]
    cc = np.arange(c, dtype=np.float32)[None, None, :]
    out = np.empty((n, h, w, c), np.uint16 if dtype == "uint16" else
                   np.uint8)
    for i in range(n):
        gx, gy, ph = rng.uniform(-2, 2), rng.uniform(-2, 2), rng.uniform(0, 6)
        v = (128 + 60 * np.sin(xx * gx / 37 + yy * gy / 23 + ph + cc)
             + 30 * np.sign(np.sin(yy / (5 + i % 7))))
        v = v + rng.normal(0, 3 + i % 5, (h, w, c)).astype(np.float32)
        v = v * (top / 255.0)
        out[i] = np.clip(v, 0, top).astype(out.dtype)
    return torch.from_numpy(out)


def k12(dev):
    import torch

    from picha_tpu_torch.codecs.png_host import PROBE_ORDER
    from picha_tpu_torch.ops import png_filter as pf
    from picha_tpu_torch.pipeline import png_batch

    res = {}
    for name, (n, h, w, c, dtype, singles) in K12_SHAPES.items():
        px = pixels(n, h, w, c, dtype, seed=12).to(dev)
        rows = png_batch.sample_rows(px)
        bpp = c * (2 if dtype == "uint16" else 1)
        strategies, cands = png_batch.filter_candidates(px)
        want = torch.stack([pf.filter_batch_plain(rows, bpp, s)
                            for s in strategies])
        torch.cuda.synchronize()

        def probe():
            """The probe's streams from the rows: one launch, or the
            parent's one a strategy."""
            if hasattr(pf, "filter_streams"):
                return pf.filter_streams(rows, bpp, strategies)
            out = torch.empty_like(want)
            for j, s in enumerate(strategies):
                pf.filter_batch(rows, bpp, s, out=out[j])
            return out

        r = dict(rows=list(rows.shape), bpp=bpp,
                 strategies=list(strategies), probe=dict(
                     bits=digest(cands), equal_plain=bool(torch.equal(
                         cands, want) and torch.equal(probe(), want)),
                     repeat_equal=bool(torch.equal(
                         cands, png_batch.filter_candidates(px)[1])),
                     ms=timed(probe), by_kernel=by_kernel(probe),
                     candidates_ms=timed(
                         lambda: png_batch.filter_candidates(px)),
                     bound_ms=(rows.numel() + cands.numel()) / HBM * 1e3))
        del want
        if hasattr(pf, "kernel_info"):
            r["probe"]["kernel_info"] = pf.kernel_info(
                tuple(rows.shape), bpp, tuple(strategies), dev)
        for s in singles:
            got = pf.filter_batch(rows, bpp, s)
            same = bool(torch.equal(got, pf.filter_batch_plain(rows, bpp, s)))
            torch.cuda.synchronize()
            r[str(s)] = dict(
                bits=digest(got), equal_plain=same,
                ms=timed(lambda s=s: pf.filter_batch(rows, bpp, s)),
                by_kernel=by_kernel(lambda s=s: pf.filter_batch(rows, bpp, s)),
                bound_ms=(rows.numel() + got.numel()) / HBM * 1e3)
            if hasattr(pf, "kernel_info"):
                r[str(s)]["kernel_info"] = pf.kernel_info(
                    tuple(rows.shape), bpp, (s,), dev)
            del got
        res[name] = r
        del px, rows, cands
        torch.cuda.empty_cache()
    res["probe_order"] = list(PROBE_ORDER)
    return res


def k10(dev):
    import torch

    from picha_tpu_torch.pipeline import augment as aug

    n, h, w = K10_SHAPE
    g = torch.Generator().manual_seed(10)
    x = (torch.rand((n, h, w, 3), generator=g) * 1.1 - 0.05).to(dev)
    res = {"clone_ms": timed(lambda: x.clone())}
    for name, cfg in (("contrast_on", AUGMENT), ("contrast_off",
                                                  NO_CONTRAST)):
        draws = aug.draw_augment(torch.Generator().manual_seed(11), n, h, w,
                                 cfg).to(dev)
        got = aug.augment_fused(x, draws, cfg)
        plain = aug.augment_fused_plain(x, draws, cfg)
        torch.cuda.synchronize()
        r = dict(shape=list(x.shape), bits=digest(got),
                 max_abs_err=float((got - plain).abs().max()),
                 repeat_equal=bool(torch.equal(
                     got, aug.augment_fused(x, draws, cfg))),
                 ms=timed(lambda: aug.augment_fused(x, draws, cfg)),
                 by_kernel=by_kernel(lambda: aug.augment_fused(x, draws,
                                                               cfg)),
                 bound_ms=2 * x.numel() * 4 / HBM * 1e3)
        if hasattr(aug, "kernel_info"):
            info = aug.kernel_info(tuple(x.shape), cfg, dev)
            r["kernel_info"] = info
            model = aug.augment_fused_lanes(x.cpu(), draws.to("cpu"), cfg,
                                            info["plan"])
            r["equal_lanes_model"] = bool(torch.equal(got.cpu(), model))
            del model
        res[name] = r
        del got, plain, draws
    return res


def yardsticks(dev):
    """Device-only time beside the call time of K20, K23, K24 (MoE ViT-S
    forward shapes) and K11's head and tail (config 4's call)."""
    import torch

    from picha_tpu_torch.ops import moe
    from picha_tpu_torch.ops.colorconvert import pixel_map

    out = {}
    t, e, d = 50176, 4, 384
    g = torch.Generator().manual_seed(20)
    logits = torch.randn((t, e), generator=g).to(dev)
    y = torch.randn((t, d), generator=g).to(torch.bfloat16).to(dev)
    cap = moe.capacity(t, e, 1.5)
    xe, eidx, sidx, gk = moe.route_dispatch_k19(logits, y, cap)
    ye = (xe.float() * 0.5).to(torch.bfloat16)
    dout = torch.randn((t, d), generator=g).to(torch.bfloat16).to(dev)
    dgk = torch.randn((t,), generator=g).to(dev)
    calls = {
        "K20": lambda: moe.combine_k20(ye, eidx, sidx, gk),
        "K23": lambda: moe.dispatch_backward(ye, eidx, sidx, logits, dgk),
        "K24": lambda: moe.combine_backward(dout, ye, eidx, sidx, gk),
    }
    x = pixels(256, 256, 384, 4, "uint8", seed=11).to(dev)
    head = pixel_map(x, 4, torch.float32, crop=(16, 16, 352, 224))
    xh = torch.rand((256, 112, 176, 4), generator=g).to(dev) * 1.02 - 0.01
    calls["K11_head"] = lambda: pixel_map(x, 4, torch.float32,
                                          crop=(16, 16, 352, 224))
    calls["K11_tail"] = lambda: pixel_map(xh, 4, torch.uint8)
    for name, fn in calls.items():
        out[name] = dict(ms=timed(fn), by_kernel=by_kernel(fn))
    del head
    return out


def run(label):
    """One checkout, imported from the working directory."""
    import torch

    from picha_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    res["k12"] = k12(dev)
    torch.cuda.empty_cache()
    res["k10"] = k10(dev)
    torch.cuda.empty_cache()
    res["yardsticks"] = yardsticks(dev)
    root = pathlib.Path.cwd()
    res["ptxas"] = {s: ptxas(root, s) for s in ("png_filter.cu",
                                                "augment.cu")}
    print("RESULT " + json.dumps(res), flush=True)


def bits_of(run_):
    out = {}
    for name, r in run_["k12"].items():
        if isinstance(r, dict):
            out.update({f"k12_{name}_{k}": v["bits"] for k, v in r.items()
                        if isinstance(v, dict) and "bits" in v})
    out.update({f"k10_{k}": v["bits"] for k, v in run_["k10"].items()
                if isinstance(v, dict)})
    return out


def checks_of(run_):
    ok = []
    for r in run_["k12"].values():
        if isinstance(r, dict):
            ok += [v["equal_plain"] for v in r.values()
                   if isinstance(v, dict) and "equal_plain" in v]
            ok.append(r["probe"]["repeat_equal"])
    for r in run_["k10"].values():
        if isinstance(r, dict):
            ok += [r["max_abs_err"] <= 1e-6, r["repeat_equal"],
                   r.get("equal_lanes_model", True)]
    return all(ok)


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
    runs, failed, first = [], False, None
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
        bits = bits_of(runs[-1])
        first = first or dict(label=label, bits=bits)
        same = {k: v == first["bits"].get(k) for k, v in bits.items()}
        runs[-1]["same_bits_as_first_run"] = dict(label=first["label"],
                                                  **same)
        failed |= not all(same.values()) or not checks_of(runs[-1])
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
