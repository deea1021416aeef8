#!/usr/bin/env python3
"""Time variants of the JPEG encoder front (K2) on one CUDA card, each a
text edit of this checkout's `csrc/jpeg_encode_front.cu` built alone.

    python3 tools/torch_encode_variants.py [--json OUT] [NAME ...]

Each variant (VARIANTS below; all of them by default) copies the source
into a directory of its own under `picha_tpu_torch/csrc/build/variants_k2/`,
applies its edits and builds it with nvcc into a library of its own (all
at once), printing `-Xptxas -v`'s registers and spills. Then, in one
process, each library's `picha_jpeg_encode_front` runs on seeded
16 x 544 x 960 x 3 float32 pixels in [-10, 265) (the fused transcode's
K2 shape; K2's work does not depend on the values) and on the first
image alone, and reports: a digest of the coefficients (the variants
that keep the arithmetic must give the first variant's), CUDA-event ms
of a launch (median of 3 rounds of 20) and the kernel's device ms
(torch.profiler). The ablations (`no_*`, `recip_quant`) compute wrong
coefficients on purpose: they time what is left without a phase;
`phases` adds clock64() reads of each CTA's thread 0 around each phase
of a tile and reports the cycles a CTA spends in each (one launch).
Prints the card's name and power limit, then one JSON line a variant.
"""
import ctypes
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "picha_tpu_torch" / "csrc"
OUT = CSRC / "build" / "variants_k2"
SRC = "jpeg_encode_front.cu"
SHAPES = {"n16": (16, 544, 960, 3), "n1": (1, 544, 960, 3)}

# clock64() of thread 0 of each CTA around each phase of a tile, summed
# over the grid into phase_cycles[]: load wait + barrier, convert + the
# next tile's units + barrier, the next tile's load issue, fDCT,
# quantisation, stores
PHASES = ("wait_loads", "convert", "issue_loads", "fdct", "quantise",
          "store")
PHASE_EDITS = [
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ unsigned long long phase_cycles[8];\n\n"
     "namespace {\n\nconstexpr int kThreads"),
    ("    cp_wait_all();\n    __syncthreads();\n",
     "    long long c0 = clock64();\n    cp_wait_all();\n"
     "    __syncthreads();\n    long long c1 = clock64();\n"),
    ("    __syncthreads();\n    if (next < g.n_tiles) load_tile",
     "    __syncthreads();\n    long long c2 = clock64();\n"
     "    if (next < g.n_tiles) load_tile"),
    ("    // fDCT: acc[j][r]",
     "    long long c3 = clock64();\n    // fDCT: acc[j][r]"),
    ("    __syncwarp();\n    // the quotients",
     "    __syncwarp();\n    long long c4 = clock64();\n"
     "    // the quotients"),
    ("    __syncwarp();\n    // the warp's",
     "    __syncwarp();\n    long long c5 = clock64();\n"
     "    // the warp's"),
    ("          *reinterpret_cast<const int4*>(smp + b * kRow + piece * 4);"
     "\n    }\n  }\n}",
     "          *reinterpret_cast<const int4*>(smp + b * kRow + piece * 4);"
     "\n    }\n    long long c6 = clock64();\n"
     "    if (threadIdx.x == 0) {\n"
     "      const long long c[7] = {c0, c1, c2, c3, c4, c5, c6};\n"
     "      for (int p = 0; p < 6; ++p)\n"
     "        atomicAdd(phase_cycles + p, "
     "static_cast<unsigned long long>(c[p + 1] - c[p]));\n"
     "    }\n  }\n}"),
    ("// K2's build and plan for c channels",
     "extern \"C\" int picha_phase_cycles(unsigned long long* out, "
     "int reset) {\n"
     "  static const unsigned long long zero[8] = {};\n"
     "  cudaDeviceSynchronize();\n"
     "  if (reset) return static_cast<int>(cudaMemcpyToSymbol("
     "phase_cycles, zero, sizeof(zero)));\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, phase_cycles, "
     "sizeof(zero)));\n}\n\n// K2's build and plan for c channels"),
]
CONVERT = "    convert_tile<kColour>(g, units[buf], raw, smp);\n"
LOAD = ("    if (next < g.n_tiles) load_tile<kColour>(img, g, units[buf ^ 1], "
        "raw);\n")

# name -> [(text, replacement)] in SRC
VARIANTS = {
    "final": [],
    "phases": PHASE_EDITS,
    # the fDCT's loop run zero times: load, convert, quantise, store
    "no_gemm": [("for (int c = 0; c < 16; ++c) {",
                 "for (int c = 0; c < 0; ++c) {")],
    # samples left as they are: load, fDCT, quantise, store
    "no_convert": [(CONVERT, "")],
    # no pixel loads after the first tile's
    "no_load": [(LOAD, "")],
    # the loads alone: no convert, fDCT, quantisation or stores
    "loads_only": [(CONVERT, ""),
                   ("    // fDCT: acc[j][r]", "    continue;\n"
                    "    // fDCT: acc[j][r]")],
    # a multiply by the table in place of the IEEE division
    "recip_quant": [("rintf(acc[j][r] / q[k])", "rintf(acc[j][r] * q[k])")],
    # the tile's units by 32-bit divisions
    "units32": [("    const long long per = static_cast<long long>(g.uh) * "
                 "g.uw;\n    const int n = static_cast<int>(q / per);\n"
                 "    const int rem = static_cast<int>(q - n * per);\n",
                 "    const int per = g.uh * g.uw, qi = static_cast<int>(q);"
                 "\n    const int n = qi / per;\n"
                 "    const int rem = qi - n * per;\n")],
}


def prepare(name):
    """Copy and edit the source; start nvcc. Returns (library, process)."""
    from picha_tpu_torch.kernels import _build

    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    text = (CSRC / SRC).read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: text not found: {old!r}")
        text = text.replace(old, new)
    (d / SRC).write_text(text)
    lib = d / "lib.so"
    p = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(d / SRC)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return lib, p


def grid(lib, f):
    """The launch's CTAs, from the variant's own info function."""
    out = (ctypes.c_int * 8)()
    if lib.picha_jpeg_encode_front_info(f.shape[3], out):
        raise RuntimeError("picha_jpeg_encode_front_info failed")
    n, h, w, c = f.shape
    side = 16 if c == 3 else 8
    tiles = -(-n * -(-h // side) * -(-w // side) // out[7])
    return min(tiles, out[4] * out[5])


def ptxas_summary(log):
    return [dict(registers=int(m.group(1)))
            for m in re.finditer(r"Used (\d+) registers", log)] + [
        dict(spill=int(m.group(1)))
        for m in re.finditer(r"(\d+) bytes spill stores", log)]


def main(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from picha_tpu_torch.ops import jpeg as jp

    out_path = None
    if len(argv) > 2 and argv[1] == "--json":
        out_path, argv = pathlib.Path(argv[2]).resolve(), argv[2:]
    names = argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    builds = {n: prepare(n) for n in names}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(22)
    ql, qc = jp.quality_tables(85)
    ql = torch.as_tensor(ql.astype("int32"), device=dev)
    qc = torch.as_tensor(qc.astype("int32"), device=dev)
    kron = torch.as_tensor(jp._idct_kron(), device=dev)
    images = {k: (torch.rand(s, generator=g) * 275.0 - 10.0).to(dev)
              for k, s in SHAPES.items()}
    P, I = ctypes.c_void_p, ctypes.c_int
    results, first = [], {}
    for name, (lib_path, p) in builds.items():
        log = p.communicate()[0]
        if p.returncode:
            print(name, "build failed", log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.picha_jpeg_encode_front
        fn.argtypes = [P, I, I, I, I, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
        res = dict(variant=name, ptxas=ptxas_summary(log), shapes={})
        for key, f in images.items():
            n, h, w, c = f.shape
            ybh, ybw = -(-h // 8), -(-w // 8)
            cbh, cbw = -(-((h + 1) // 2) // 8), -(-((w + 1) // 2) // 8)
            oy = torch.empty((n, ybh, ybw, 64), dtype=torch.int16, device=dev)
            ocb = torch.empty((n, cbh, cbw, 64), dtype=torch.int16,
                              device=dev)
            ocr = torch.empty_like(ocb)

            def call():
                rc = fn(f.data_ptr(), n, h, w, c, ql.data_ptr(),
                        qc.data_ptr(), kron.data_ptr(), oy.data_ptr(),
                        ocb.data_ptr(), ocr.data_ptr(), ybh, ybw, cbh, cbw,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            hsh = hashlib.sha256()
            for t in (oy, ocb, ocr):
                hsh.update(t.cpu().numpy().tobytes())
            bits = hsh.hexdigest()[:16]
            first.setdefault(key, bits)
            rounds = []
            for _ in range(3):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                for _ in range(20):
                    call()
                b.record()
                torch.cuda.synchronize()
                rounds.append(a.elapsed_time(b) / 20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            dev_ms = sum((getattr(e, "device_time_total", 0)
                          or getattr(e, "cuda_time_total", 0))
                         for e in prof.key_averages()) / 1e3 / 10
            res["shapes"][key] = dict(
                bits=bits, same_bits_as_first=bits == first[key],
                ms=sorted(rounds)[1], kernel_ms=dev_ms)
            if hasattr(lib, "picha_phase_cycles"):
                cyc = (ctypes.c_ulonglong * 8)()
                lib.picha_phase_cycles(cyc, 1)
                call()
                lib.picha_phase_cycles(cyc, 0)
                res["shapes"][key]["phase_cycles_a_cta"] = {
                    ph: cyc[i] / grid(lib, f) for i, ph in enumerate(PHASES)}
        results.append(res)
        print(json.dumps(res), flush=True)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"card": smi, "variants": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    sys.exit(main(sys.argv))
