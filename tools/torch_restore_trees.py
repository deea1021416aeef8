#!/usr/bin/env python3
"""Time the port's host-coefficient restores (K27-K30) of several
checkouts in turns on one CUDA card.

    python3 tools/torch_restore_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, on the
wires `chip_smoke.py`'s phase 20 restores (the 16 restart-8 1920x1088
q85 4:2:0 sources of `tests/fixtures/port/src_*.jpg`, decoded by the
host C++ decoder, packed by the C++ packers) and on 4 of them re-encoded
at q = 100, reports for each of the uploads sparse (K27), int8 (K28),
gap8 (K29) and gap4 (K30): a digest of the planes and their equality
with the restore's plain version; CUDA-event medians of
`restore_planes` (the batch's call: the unpack and the three components'
restores), of the restores alone (sparse, gap8, gap4) and of the unpack
alone (gap8, gap4); the call's device time split by kernel name
(torch.profiler: K27's writes and adds, K29's and K30's tile sums,
writes and adds, or a parent's memsets, walks and corrections), the
restores' alone likewise; the bound (wire and planes over 3.35 TB/s);
`kernel_info` of the restores where the checkout has it, and `nvcc
-Xptxas -v` of its `coef_restore.cu`; then the whole
`JpegBatchPipeline(upload="gap4")` and `upload="gap8"` call on the
restart corpus (fused, 960x544 q85; wall-clock medians of 3). Prints the
card's name and power limit, then one JSON line a run; with --json, also
writes them all to OUT. The main process checks every digest against the
first run's.
"""
import hashlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

TOOL_ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = TOOL_ROOT / "tests" / "fixtures" / "port"
N_IMG, Q100_N = 16, 4
UPLOADS = {"sparse": "densify", "int8": "int8_restore",
           "gap8": "gap8_restore", "gap4": "gap4_restore"}
HBM = 3.35e12


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


def wall(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return sorted(out)[reps // 2]


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
            rows[name] = {"ms": us / 1e3 / reps, "launches": e.count / reps}
    rows["sum_ms"] = sum(v["ms"] for v in rows.values())
    return rows


def ptxas(root):
    """Registers, stack, spill and shared bytes of every kernel of the
    checkout's coef_restore.cu (`nvcc -Xptxas -v`)."""
    from picha_tpu_torch.kernels import _build

    p = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull,
         str(root / "picha_tpu_torch" / "csrc" / "coef_restore.cu")],
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


def corpora():
    from PIL import Image

    srcs = [(FIXTURES / f"src_{i}.jpg").read_bytes() for i in range(3)]
    bufs = [srcs[i % 3] for i in range(N_IMG)]
    hi = []
    for b in bufs[:Q100_N]:
        out = io.BytesIO()
        Image.open(io.BytesIO(b)).convert("RGB").save(out, "JPEG",
                                                      quality=100)
        hi.append(out.getvalue())
    return bufs, hi


def run(label):
    """One checkout, imported from the working directory."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    import torch

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.ops import coef_host
    from picha_tpu_torch.ops import coef_restore as cr
    from picha_tpu_torch.ops.jpeg_scan import parse_baseline
    from picha_tpu_torch.pipeline import JpegBatchPipeline
    from picha_tpu_torch.pipeline.jpeg_batch import (restore_planes,
                                                     stack_coefficients,
                                                     upload_args)

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "uploads": {}}
    bufs, hi = corpora()
    pool = ThreadPoolExecutor(max_workers=8)
    batches = {name: coef_host.entropy_decode(
        [parse_baseline(bytes(b)) for b in bb], True, pool, 8)
        for name, bb in (("restart", bufs), ("q100", hi))}
    plains = {k: getattr(cr, k + "_plain") for k in UPLOADS.values()}
    for upload, fn in UPLOADS.items():
        r = {}
        for name, cos in batches.items():
            sig, ks, args = stack_coefficients(cos, upload, native=True)
            dargs = upload_args(args, dev)
            kw = {upload + "_ks": ks}
            got, _q = restore_planes(sig, dargs, **kw)
            with mock.patch.multiple(cr, **plains):
                want, _wq = restore_planes(sig, dargs, **kw)
            torch.cuda.synchronize()
            r[name] = dict(bits=digest(got), equal_plain=all(
                bool(torch.equal(a, b)) for a, b in zip(got, want)))
            if name != "restart":
                continue
            wire = sum(a.nbytes for a in args if a.dtype.name != "uint16")
            planes = sum(g.numel() * 4 for g in got)
            r.update(wire_bytes=int(wire), plane_bytes=int(planes),
                     bound_ms=(wire + planes) / HBM * 1e3,
                     call_ms=timed(lambda: restore_planes(sig, dargs, **kw)),
                     call_by_kernel=by_kernel(
                         lambda: restore_planes(sig, dargs, **kw)))
            if upload != "int8":
                restore = getattr(cr, fn)
                if upload == "sparse":
                    parts = [dargs[2 * i:2 * i + 2]
                             for i in range(len(sig[3]))]
                else:
                    unpack = cr.unpack_gap8 if upload == "gap8" else \
                        cr.unpack_gap4
                    parts, _qt = unpack(dargs[0], ks, len(sig[3]))
                    r["unpack_ms"] = timed(
                        lambda: unpack(dargs[0], ks, len(sig[3])))

                def restores():
                    return [restore(*p, c[0], c[1])
                            for p, c in zip(parts, sig[3])]
                r["restores_ms"] = timed(restores)
                r["restores_by_kernel"] = by_kernel(restores)
                r["per_component"] = [
                    dict(entries=list(p[0].shape) + (
                        [] if upload == "sparse" else
                        [p[1].shape[1], p[-1].numel()]),
                         ms=timed(lambda p=p, c=c: restore(*p, c[0], c[1])))
                    for p, c in zip(parts, sig[3])]
            if hasattr(cr, "kernel_info"):
                r["kernel_info"] = cr.kernel_info()
            del dargs, got, want
        res["uploads"][upload] = r
        torch.cuda.empty_cache()
    res["ptxas"] = ptxas(pathlib.Path.cwd())
    for upload in ("gap4", "gap8"):
        p = JpegBatchPipeline(width=960, height=544, encode_quality=85,
                              encode_backend="device", fused=True,
                              upload=upload, num_threads=8, device=dev)
        res[f"pipeline_{upload}_ms"] = wall(lambda: p(bufs))
        p.close()
    pool.shutdown()
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
    runs, failed, first = [], False, None
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
            continue
        runs.append(json.loads(line[0][7:]))
        bits = {f"{u}_{name}": r[name]["bits"]
                for u, r in runs[-1]["uploads"].items()
                for name in ("restart", "q100")}
        first = first or dict(label=label, bits=bits)
        same = {k: v == first["bits"][k] for k, v in bits.items()}
        runs[-1]["same_bits_as_first_run"] = dict(label=first["label"],
                                                  **same)
        failed |= not all(same.values()) or not all(
            r[name]["equal_plain"] for r in runs[-1]["uploads"].values()
            for name in ("restart", "q100"))
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
