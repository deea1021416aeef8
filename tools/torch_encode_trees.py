#!/usr/bin/env python3
"""Time the port's JPEG encoder front (K2) and scan encode (K3) of several
checkouts in turns on one CUDA card.

    python3 tools/torch_encode_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and makes
K2's input as the fused restart-8 transcode does: the 16 fixture JPEGs
of `chip_smoke.py` (tests/fixtures/port/src_{0,1,2}.jpg, 1920 x 1088)
through K1 and the fused decode + resize into 16 x 544 x 960 x 3
float32, q85, the pipeline's scan byte cap (98,304). At that shape
(`n16`) and at the first image alone (`n1`, the one-image call) it
reports:

  K2  digests of the quantised planes (which must match across
      checkouts), the coefficients that differ from
      `encode_blocks_plain` (off by one only at f32 .5 ties), CUDA-event
      ms of the call, its kernels by name (torch.profiler), the bound
      (the float image read once and the int16 planes written once over
      3.35 TB/s, or 64 FMAs a coefficient over 67 TFLOP/s), the host ms
      a call takes to return on an idle card (its enqueue);
  K3  digests of the scan bytes and `nbytes` at the cap and at a 4,096
      byte cap (overflow), equality with `scan_encode_plain` in the full
      (N, cap) buffers, CUDA-event ms of the call, its device time by
      kernel name (memsets and copies under their own names), its
      enqueue ms, the bound (the planes read once, the scan bytes and
      `nbytes` written once);

then `ops.jpeg.encode_kernel_info` / `ops.jpeg_huffman.kernel_info`
where the checkout has them and `nvcc -Xptxas -v` of both sources.
Prints the card's name and power limit, then one JSON line a run; with
--json, also writes them all to OUT. The main process checks every
run's digests against the first run's.
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
FP32 = 67e12
N_IMG, OUT_W, OUT_H, QUALITY = 16, 960, 544, 85
SMALL_CAP = 4096
SOURCES = ("jpeg_encode_front.cu", "huffman_encode_scan.cu")


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


def enqueue_ms(fn, reps=20):
    """Host ms a call of fn takes to return (its launches enqueued on an
    idle card, before any wait for the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def by_kernel(fn, reps=10):
    """Device ms and launches a call of fn, by kernel name
    (torch.profiler; memsets under their own name), and their sum."""
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


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def transcode_input(dev):
    """The fused restart-8 transcode's K2 input and its scan constants."""
    import torch

    from picha_tpu_torch.ops.jpeg_fused import fused_decode_resize
    from picha_tpu_torch.ops.jpeg_huffman_decode import (decode_scan,
                                                         scan_wire,
                                                         split_planes,
                                                         wire_unpack)
    from picha_tpu_torch.pipeline import JpegBatchPipeline
    from picha_tpu_torch.pipeline.jpeg_batch import signature

    fixtures = pathlib.Path.cwd() / "tests" / "fixtures" / "port"
    srcs = [(fixtures / f"src_{i}.jpg").read_bytes() for i in range(3)]
    corpus = [srcs[i % 3] for i in range(N_IMG)]
    pipe = JpegBatchPipeline(width=OUT_W, height=OUT_H,
                             encode_quality=QUALITY, encode_backend="device",
                             fused=True, upload="scan", device=dev)
    infos = pipe.entropy_decode(corpus)
    ks, wire = scan_wire(infos)
    sig = signature(infos[0])
    consts = pipe.constants(sig)
    dargs, qtabs = wire_unpack(torch.from_numpy(wire).to(dev), ks,
                               len(sig[3]))
    coefs, ok = decode_scan(dargs, ks, consts.comp_of)
    planes = split_planes(coefs, sig[3], consts.split_idx)
    f255 = fused_decode_resize(sig[3], sig[2], planes, qtabs, consts.weights)
    torch.cuda.synchronize()
    if not bool(ok):
        raise AssertionError("K1 failed on the fixture corpus")
    return f255, consts, pipe._scan_cap_for(sig)


def run(label):
    """One checkout, imported from the working directory."""
    import torch

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.ops import jpeg as jp
    from picha_tpu_torch.ops import jpeg_huffman as jh

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "shapes": {}}
    f16, consts, cap = transcode_input(dev)
    res.update(byte_cap=cap, f255_bits=digest([f16]))
    for name, f255 in (("n16", f16), ("n1", f16[:1].contiguous())):
        front = (f255, consts.qluma, consts.qchroma, consts.kron)
        blocks = jp.encode_blocks(*front)
        plain = jp.encode_blocks_plain(*front)
        off = sum(int((a != b).sum()) for a, b in zip(blocks, plain))
        elems = sum(b.numel() for b in blocks)
        r = dict(shape=list(f255.shape), k2_bits=digest(blocks),
                 k2_off_plain=off, k2_coefficients=elems)
        r["k2_ms"] = timed(lambda: jp.encode_blocks(*front))
        r["k2_enqueue_ms"] = enqueue_ms(lambda: jp.encode_blocks(*front))
        r["k2_by_kernel"] = by_kernel(lambda: jp.encode_blocks(*front))
        r["k2_bound_ms"] = max((f255.numel() * 4 + elems * 2) / HBM,
                               elems * 128 / FP32) * 1e3
        if hasattr(jp, "encode_kernel_info"):
            r["k2_kernel_info"] = jp.encode_kernel_info(f255)
        lay, tab = consts.layout, consts.tab
        for c, tag in ((cap, "k3"), (SMALL_CAP, "k3_small")):
            out, nb = jh.scan_encode(blocks, lay, tab, c)
            want, nb_want = jh.scan_encode_plain(blocks, lay, tab, c)
            r[f"{tag}_bits"] = digest([out, nb])
            r[f"{tag}_equal_plain"] = bool(torch.equal(out, want)
                                           and torch.equal(nb, nb_want))
            r[f"{tag}_nbytes_max"] = int(nb.max())
            r[f"{tag}_overflow"] = int((nb > c).sum())
        nb = jh.scan_encode(blocks, lay, tab, cap)[1]
        r["k3_ms"] = timed(lambda: jh.scan_encode(blocks, lay, tab, cap))
        r["k3_enqueue_ms"] = enqueue_ms(
            lambda: jh.scan_encode(blocks, lay, tab, cap))
        r["k3_by_kernel"] = by_kernel(
            lambda: jh.scan_encode(blocks, lay, tab, cap))
        r["k3_bound_ms"] = (elems * 2 + int(nb.sum()) + nb.numel() * 4) \
            / HBM * 1e3
        if hasattr(jh, "kernel_info"):
            r["k3_kernel_info"] = jh.kernel_info(blocks, lay, cap)
        res["shapes"][name] = r
        del blocks, plain
        torch.cuda.empty_cache()
    res["ptxas"] = {s: ptxas(pathlib.Path.cwd(), s) for s in SOURCES}
    print("RESULT " + json.dumps(res), flush=True)


DIGESTS = ("k2_bits", "k3_bits", "k3_small_bits")


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
        bits = {s: {k: r[k] for k in DIGESTS}
                for s, r in runs[-1]["shapes"].items()}
        first = first or dict(label=label, bits=bits)
        same = {s: {k: v == first["bits"][s][k] for k, v in b.items()}
                for s, b in bits.items()}
        runs[-1]["same_bits_as_first_run"] = dict(label=first["label"],
                                                  **same)
        failed |= not all(all(v.values()) for v in same.values())
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
