#!/usr/bin/env python3
"""Time the port's staged JPEG decode kernels (K4 + K5 chunked Huffman
decode and DC scan, `split_planes`, K6 dequant + IDCT per component, K7
upsample + colour) of several checkouts in turns on one CUDA card.

    python3 tools/torch_jpeg_decode_trees.py [--json OUT] [--k1-only]
        LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and decodes
the same corpus at three shapes: (a) the transcode's 16 and (b) the
training ingest's 256 no-restart 1920x1088 q85 4:2:0 JPEGs, the three
`tests/fixtures/port/src_nr_*.jpg` of this script's own checkout tiled;
(c) 16 of them re-encoded by Pillow with optimize=True at qualities
80-95, each with its own Huffman tables (as mozjpeg writes by default):
64 unique table rows, which K4 reads from global memory where (a) and
(b)'s 4 rows sit in shared memory.
For each shape it reports: digests of K4 + K5's coefficients and of K6's
planes (int32 and int16 coefficients; they must be equal across
checkouts), `ok` and the Jacobi passes run; CUDA-event medians of K4 +
K5 (`decode_scan_chunked`), K4 alone, K4 with `max_passes` set to the
passes it needs, K5, the split, K6 per component on int32 and on int16
coefficients, and K7; the unique table rows; each kernel's device time by name from
torch.profiler (the pass, settle, block-start and emission launches
apart); the bounds (bytes over 3.35 TB/s; K6 also its operations over
67 TFLOP/s, dense and on this data's nonzero coefficients); the
one-call yardstick of K6 (the dequantised blocks' product with the
Kronecker IDCT, full f32); and, at (a) and (c), equality with
`decode_scan_chunked_plain`. K7 also: a digest of its output, equality
with `upsample_color_plain` on the card, its bound (planes in, pixels
out) and, where the checkout has `k7_build`, the build it launches;
then K7 alone on 16 seeded random 1920x1088 planes of its other
compiled-in signatures (4:2:2, 4:4:4, grey, grey to rgb: the checkout's
`ops.jpeg.K7_SIGNATURES`; "not available" for a checkout without
them), through this script's own `chip_smoke.k7_signature_buckets`.
Then the builds: `nvcc -Xptxas -v` of the checkout's four
sources, and `kernel_info()` at each shape where the checkout has it.

Then the restart decode K1 at three shapes of the same images with
restart markers every 8 MCUs: (ra) the slice's 16 and (rb) 256 of the
three `tests/fixtures/port/src_*.jpg` tiled, (rc) 16 of them re-encoded
by Pillow with optimize=True and restart markers every 8 MCUs at
qualities 80-95 (each image its own tables: K1 reads them from global
memory). For each: a digest of the coefficients (equal across
checkouts), ok, CUDA-event medians of the call (`decode_scan`), the
call's device time by kernel name (the decode kernel alone, apart from
the parent's zeroing and the new table build), the symbols of every
lane (the plain step on the card) and the longest, that lane alone (one
lane's launch: the chain's floor) and ns a symbol (this script's own
`chip_smoke.k1_chain`), the bound, at (ra)
and (rc) equality with `decode_scan_plain`, and `restart_kernel_info`
where the checkout has it. --k1-only runs these alone (with the
ptxas of the restart source).
Prints the card's name and power limit, then one JSON line a run; with
--json, also writes them all to OUT.
"""
import hashlib
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "tests" / \
    "fixtures" / "port"
SHAPES = {"a": 16, "b": 256, "c": 16}
OWN_TABLES = "c"      # the shape whose images carry their own tables
HBM, FP32 = 3.35e12, 67e12
SOURCES = ("huffman_decode_chunked.cu", "jpeg_idct_plane.cu",
           "jpeg_upsample_color.cu", "huffman_decode_restart.cu")
RESTART_SHAPES = {"ra": 16, "rb": 256, "rc": 16}
TOOL_ROOT = pathlib.Path(__file__).resolve().parent.parent


def timed(fn, reps=10, rounds=3):
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


def by_kernel(fn, reps=5):
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
            rows[name] = {"ms": us / 1e3 / reps, "launches": e.count / reps}
    return rows


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bound(nbytes, flops=0):
    t_b, t_o = nbytes / HBM * 1e3, flops / FP32 * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def ptxas(root, sources=SOURCES):
    """Registers, stack, spill and shared bytes of every kernel of the
    checkout's sources (`nvcc -Xptxas -v`)."""
    from picha_tpu_torch.kernels import _build

    out = {}
    for src in sources:
        p = subprocess.run(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull,
             str(root / "picha_tpu_torch" / "csrc" / src)],
            capture_output=True, text=True, timeout=600)
        cur = None
        for line in (p.stdout + p.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
                out[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if m:
                out[cur].update(stack=int(m.group(1)), spill=int(m.group(2)))
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m:
                out[cur].update(registers=int(m.group(1)),
                                smem=int(m.group(2) or 0))
    return out


def corpus(shape):
    """The shape's JPEG files (see the module's docstring)."""
    from PIL import Image

    restart = shape in RESTART_SHAPES
    stem = "src_" if restart else "src_nr_"
    srcs = [(FIXTURES / f"{stem}{i}.jpg").read_bytes() for i in range(3)]
    n = (RESTART_SHAPES if restart else SHAPES)[shape]
    if shape not in (OWN_TABLES, "rc"):
        return [srcs[i % 3] for i in range(n)]
    kw = {"restart_marker_blocks": 8} if restart else {}
    out = []
    for i in range(n):
        b = io.BytesIO()
        Image.open(io.BytesIO(srcs[i % 3])).save(b, "JPEG", quality=80 + i,
                                                 optimize=True, **kw)
        out.append(b.getvalue())
    return out


def own_chip_smoke():
    """This script's own checkout's chip_smoke.py as a module (its helpers
    take the checkout's modules as arguments, so every checkout is
    measured by the same code)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_own", TOOL_ROOT / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own


def restart_run(shape, dev):
    """K1 at one restart shape (see the module's docstring)."""
    import torch

    from picha_tpu_torch.ops import jpeg_huffman_decode as hd
    from picha_tpu_torch.ops.jpeg_scan import mcu_slot_tables, parse_baseline

    infos = [parse_baseline(b) for b in corpus(shape)]
    ks, wire = hd.scan_wire(infos)
    comp_of = torch.as_tensor(mcu_slot_tables(infos[0].comp_sig)).to(
        dev, torch.int32)
    args, _q = hd.wire_unpack(torch.from_numpy(wire).to(dev), ks,
                              infos[0].ncomp)
    assert ks[9], "not a restart single-pass batch"
    r = {"images": len(infos), "lanes": ks[1], "steps": ks[2],
         "unique_table_rows": ks[7], "wire_bytes": int(wire.nbytes)}
    if hasattr(hd, "restart_kernel_info"):
        r["kernel_info"] = hd.restart_kernel_info(ks[7], ks[1])

    def call():
        return hd.decode_scan(args, ks, comp_of)

    coefs, ok = call()
    r.update(ok=bool(ok), coefs_bits=digest(coefs))
    if shape in ("ra", "rc"):
        want, ok_p = hd.decode_scan_plain(args, ks, comp_of)
        r["equal_to_plain"] = bool(torch.equal(coefs, want)
                                   and bool(ok_p) == bool(ok))
        del want
    r["call_ms"] = timed(call, reps=5)
    r.update(bound(wire.nbytes + coefs.numel() * 4))
    del coefs
    # the call's kernels, every lane's symbols, the longest lane alone
    r.update(own_chip_smoke().k1_chain(
        hd, args, ks, comp_of, lambda fn, reps: timed(fn, reps=reps)))
    torch.cuda.empty_cache()
    return r


def shape_run(shape, dev):
    import torch

    from picha_tpu_torch.ops import jpeg as jp
    from picha_tpu_torch.ops import jpeg_huffman_decode as hd
    from picha_tpu_torch.ops.jpeg_scan import mcu_slot_tables, parse_baseline
    from picha_tpu_torch.ops.scan_batch import split_indices
    from picha_tpu_torch.pipeline.jpeg_batch import signature

    infos = [parse_baseline(b) for b in corpus(shape)]
    n = len(infos)
    ks, wire = hd.scan_wire(infos)
    width, height, cs, comp_sig = signature(infos[0])
    comp_of = torch.as_tensor(mcu_slot_tables(comp_sig)).to(dev, torch.int32)
    split_idx = [torch.as_tensor(i).to(dev, torch.int64)
                 for i in split_indices(comp_sig)]
    kron = torch.as_tensor(jp._idct_kron()).to(dev)
    buf = torch.from_numpy(wire).to(dev)
    args, qtabs = hd.wire_unpack(buf, ks, len(comp_sig))
    mcus = ks[5]
    r = {"images": n, "lanes": ks[1], "steps": ks[2], "chunk_bits": ks[0],
         "unique_table_rows": ks[7], "wire_bytes": int(wire.nbytes)}
    if hasattr(hd, "kernel_info"):
        try:
            r["kernel_info"] = hd.kernel_info(n_uniq=ks[7], n_lanes=ks[1])
        except TypeError:   # a checkout whose kernel_info takes other keys
            r["kernel_info"] = "not available"

    def k45(max_passes=hd.MAX_PASSES):
        return hd.decode_scan_chunked(args, ks, comp_of, max_passes)

    def k4(max_passes=hd.MAX_PASSES):
        return hd._decode_scan_chunked_kernel(args, ks, comp_of, max_passes)

    coefs, ok, passes = k45()
    passes = int(passes)
    r.update(ok=bool(ok), passes=passes, coefs_bits=digest(coefs))
    if shape in ("a", OWN_TABLES):
        want, ok_p, passes_p = hd.decode_scan_chunked_plain(args, ks, comp_of)
        r["equal_to_plain"] = bool(torch.equal(coefs, want)
                                   and bool(ok_p) == bool(ok)
                                   and int(passes_p) == passes)
        del want
    r["k4_k5_ms"] = timed(k45, reps=5)
    r["k4_ms"] = timed(k4, reps=5)
    r["k4_ms_max_passes_fit"] = timed(lambda: k4(passes), reps=5)
    r["k4_k5_kernels"] = by_kernel(k45)
    diffs = k4()[0]
    r["k5_ms"] = timed(lambda: hd.dc_integrate(diffs, comp_of, args.ri_blk,
                                               mcus))
    del diffs
    nblk = coefs.shape[0] * coefs.shape[1]
    r["k4_k5_bound"] = bound(wire.nbytes + coefs.numel() * 4)
    r["k5_bound"] = bound(nblk * 8)
    r["split_ms"] = timed(lambda: hd.split_planes(coefs, comp_sig, split_idx))
    planes = hd.split_planes(coefs, comp_sig, split_idx)
    del coefs
    geom = jp.plane_geometry(comp_sig, width, height)
    r["k6"] = []
    ys = []
    for c, (p, q, (dh, dw, _fx, _fy)) in enumerate(zip(planes, qtabs, geom)):
        y = jp.dequant_idct_plane(p, q, kron, dh, dw)
        p16 = p.to(torch.int16)
        y16 = jp.dequant_idct_plane(p16, q, kron, dh, dw)
        deq = (p.to(torch.float32) * q.to(torch.float32)).reshape(-1, 64)
        nnz = int((deq != 0).sum())
        with jp.full_fp32():
            lib = timed(lambda: torch.matmul(deq, kron), reps=5)
        del deq
        r["k6"].append({
            "plane": list(y.shape), "bits": digest(y),
            "int16_equal": bool(torch.equal(y, y16)),
            "ms": timed(lambda: jp.dequant_idct_plane(p, q, kron, dh, dw)),
            "ms_int16": timed(lambda: jp.dequant_idct_plane(p16, q, kron, dh,
                                                            dw)),
            "library_ms": lib, "nonzero": nnz, "coefficients": p.numel(),
            "bound_dense": bound(p.numel() * 4 + y.numel(), p.numel() * 128),
            "bound": bound(p.numel() * 4 + y.numel(), nnz * 128),
            "bound_int16": bound(p.numel() * 2 + y.numel(), nnz * 128)})
        ys.append(y)
        del p16, y16
    for k in ("ms", "ms_int16", "library_ms"):
        r[f"k6_sum_{k}"] = sum(x[k] for x in r["k6"])
    r["k6_sum_bound_ms"] = sum(x["bound"]["bound_ms"] for x in r["k6"])
    r["k6_sum_bound_dense_ms"] = sum(x["bound_dense"]["bound_ms"]
                                     for x in r["k6"])
    r["k6_kernels"] = by_kernel(lambda: [
        jp.dequant_idct_plane(p, q, kron, dh, dw)
        for p, q, (dh, dw, _fx, _fy) in zip(planes, qtabs, geom)])
    r["k7"] = k7_record(ys, comp_sig, cs, width, height, True)
    r["k6_planes_bits"] = digest(*ys)
    del planes, ys
    torch.cuda.empty_cache()
    return r


def k7_record(planes, comp_sig, cs, width, height, force_rgb):
    """K7 on these planes: digest, equality with the plain version on
    the card, CUDA-event ms, bound, and the build where the checkout
    names it."""
    import torch

    from picha_tpu_torch.ops import jpeg as jp

    args = (planes, comp_sig, cs, width, height, force_rgb)
    rgb = jp.upsample_color(*args)
    want = jp.upsample_color_plain(*args)
    rec = {"bits": digest(rgb), "equal_to_plain": bool(torch.equal(rgb, want)),
           "ms": timed(lambda: jp.upsample_color(*args)),
           **bound(sum(p.numel() for p in planes) + rgb.numel())}
    if hasattr(jp, "k7_build"):
        rec["build"] = jp.k7_build(comp_sig, cs, width, height, force_rgb)
    del rgb, want
    return rec


def run(label, k1_only=False):
    """One checkout, imported from the working directory."""
    import torch

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.ops import jpeg as jp

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    for name in RESTART_SHAPES:
        res[name] = restart_run(name, dev)
    if k1_only:
        res["ptxas"] = ptxas(pathlib.Path.cwd(), SOURCES[-1:])
        print("RESULT " + json.dumps(res), flush=True)
        return
    for name in SHAPES:
        res[name] = shape_run(name, dev)
    # K7's other compiled-in signatures, through this script's own
    # chip_smoke.k7_signature_buckets (the same planes for every checkout)
    res["k7_signatures"] = "not available"
    if hasattr(jp, "K7_SIGNATURES"):
        res["k7_signatures"] = own_chip_smoke().k7_signature_buckets(
            dev, timed, {k[3:]: v for k, v in jp.kernel_info().items()
                         if k.startswith("K7_")})
    res["ptxas"] = ptxas(pathlib.Path.cwd())
    res["kernel_info"] = {"jpeg": jp.kernel_info() if hasattr(jp, "kernel_info")
                          else "not available"}
    print("RESULT " + json.dumps(res), flush=True)


def main(argv):
    if len(argv) >= 3 and argv[1] == "--run":
        return run(argv[2], "--k1-only" in argv[3:])
    out = None
    if len(argv) > 2 and argv[1] == "--json":
        out, argv = pathlib.Path(argv[2]).resolve(), argv[2:]
    extra = []
    if len(argv) > 1 and argv[1] == "--k1-only":
        extra, argv = ["--k1-only"], argv[1:]
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
             label, *extra], cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root)),
            capture_output=True, text=True, timeout=1200)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            failed = True
            print(label, "failed", p.returncode, p.stdout[-2000:],
                  p.stderr[-4000:], flush=True)
            continue
        runs.append(json.loads(line[0][7:]))
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
