#!/usr/bin/env python3
"""Time variants of the ResNet instance-norm kernels (K25, K26) on one
CUDA card, each a text edit of this checkout's sources built alone.

    python3 tools/torch_norm_variants.py [--json OUT] [NAME ...]

Each variant (VARIANTS below; all of them by default) copies
`picha_tpu_torch/csrc/resnet_norm*.cu*` and `status.cu` into a build
directory under `picha_tpu_torch/csrc/build/variants/`, applies its
edits and builds them with nvcc into a library of their own; all
variants build at once. Then, in a process a variant, in the order
given, the checkout's `ops.instance_norm` runs on that library and
reports: a check against the plain versions at N = 4 on the stem's and
the last call's planes (mu, sigma within 1e-6, y the plain elementwise
pass on K25's statistics, dx within 1 bf16 ulp + 2^-16 of its plane's
largest), digests of the outputs, `kernel_info` at the stem, CUDA-event
ms of K25 and K26 at the four plane shapes of a `ResNetConfig()` forward
at N = 256 and their sum over its 12 calls, each kernel's ms at the stem
(torch.profiler), and how many of 2^25 seeded (a, r) pairs the kernels'
division (`div_by`) gives other bits than torch's IEEE division. Prints
the card's name and power limit, then one JSON line a variant.
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
OUT = CSRC / "build" / "variants"
FILES = ["resnet_norm.cuh", "resnet_norm.cu", "resnet_norm_bwd.cu", "status.cu"]
HDR, FWD, BWD = FILES[:3]
CALLS = {(224, 224, 64): 1, (112, 112, 64): 4, (56, 56, 128): 4, (28, 28, 256): 3}

# name -> [(file, text, replacement)]
VARIANTS = {
    "final": [],
    # one pixel in flight a thread: the loads wait as register loads do
    "ring1": [(HDR, "constexpr int kStages = 8;", "constexpr int kStages = 1;")],
    "ring4": [(HDR, "constexpr int kStages = 8;", "constexpr int kStages = 4;")],
    # K26's dx kernel at 8 channels a thread (3 blocks an SM)
    "dx8": [(BWD, "constexpr int kDxWide = 4;", "constexpr int kDxWide = 8;"),
            (BWD, "constexpr int kDxMinBlocks = 4;", "constexpr int kDxMinBlocks = 3;")],
    # __fdiv_rn for every division by sigma
    "fdiv": [(HDR, "  const uint32_t ea = (__float_as_uint(a) >> 23) & 0xffu;\n",
              "  return __fdiv_rn(a, r);\n  const uint32_t ea = (__float_as_uint(a) >> 23) & 0xffu;\n")],
}
SIGS = {"picha_resnet_norm": "P P I L I P P P", "picha_resnet_norm_info": "L I I P",
        "picha_resnet_div_check": "P P L P P",
        "picha_resnet_norm_bwd": "P P P P P I L I P P P P",
        "picha_resnet_norm_bwd_info": "L I I P"}


def prepare(name):
    """Copy and edit the sources; start nvcc. Returns (dir, process)."""
    from picha_tpu_torch.kernels import _build

    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in FILES:
        shutil.copy(CSRC / f, d / f)
    for f, old, new in VARIANTS[name]:
        text = (d / f).read_text()
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in {f}")
        (d / f).write_text(text.replace(old, new))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
           *(str(d / f) for f in FILES if f.endswith(".cu"))]
    return d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path):
    """Point the kernel loader at one variant's library."""
    from picha_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "L": ctypes.c_int64}
    for sym, sig in SIGS.items():
        fn = getattr(lib, sym)
        fn.argtypes = [types[c] for c in sig.split()]
        fn.restype = ctypes.c_int
    lib.picha_cuda_error_string.argtypes = [ctypes.c_int]
    lib.picha_cuda_error_string.restype = ctypes.c_char_p
    _build._lib = lib


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


def kernel_ms(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"::(\w+)[<(]", e.key)
            out[m.group(1) if m else e.key[:40]] = e.device_time_total / 1e3 / 5
    return out


def digest(t):
    import torch

    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def check(inm, dev):
    """The plain-version checks at N = 4; returns (ok, digests)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    ok, bits = True, {}
    for s in [(4, 224, 224, 64), (4, 28, 28, 256)]:
        x = (0.5 + 2 * torch.randn(s, generator=g, device=dev)).to(torch.bfloat16)
        sc = 1 + 0.3 * torch.randn(s[3], generator=g, device=dev)
        dy = torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
        y, mu, sg = inm.norm_relu_k25(x, sc)
        _wy, wmu, wsg = inm.norm_relu_plain(x, sc)
        ok &= torch.equal(y, inm.normalize_relu(x, sc, mu, sg))
        ok &= bool(((mu - wmu).abs() <= 1e-6 * x.float().abs().mean((1, 2))).all())
        ok &= bool(((sg - wsg).abs() <= 1e-6 * wsg).all())
        dx, _ds = inm.norm_relu_backward(x, y, dy, sc, mu, sg)
        wdx, _wds = inm.norm_relu_backward_plain(x, y, dy, sc, mu, sg)
        m = torch.maximum(dx.abs(), wdx.abs()).double().clamp_min(2.0 ** -126)
        u = torch.exp2(torch.floor(torch.log2(m)) - 7)
        plane = wdx.double().abs().amax((1, 2), keepdim=True)
        ok &= bool(((dx.double() - wdx.double()).abs() <= u + 2.0 ** -16 * plane).all())
        bits[f"{s[1]}"] = [digest(y), digest(dx)]
    return bool(ok), bits


def division_mismatches(dev):
    """Pairs of 2^25 where div_by's bits are not torch's a / r: random
    and all-ones significands, exponents past its range on both sides."""
    import torch

    from picha_tpu_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(3)
    bad = 0
    for k in range(2):
        n = 1 << 24
        a = ((torch.randint(0, 2 ** 31, (n,), generator=g, device=dev) & 0x807FFFFF)
             | (torch.randint(40, 215, (n,), generator=g, device=dev) << 23))
        r = (torch.randint(0, 2 ** 23, (n,), generator=g, device=dev)
             | (torch.randint(60, 195, (n,), generator=g, device=dev) << 23))
        if k:
            r |= 0x7FFF00
        a = a.to(torch.int32).view(torch.float32)
        r = r.to(torch.int32).view(torch.float32)
        out = torch.empty_like(a)
        rc = _build._lib.picha_resnet_div_check(a.data_ptr(), r.data_ptr(), n, out.data_ptr(),
                                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"picha_resnet_div_check: CUDA error {rc}")
        bad += int((out.view(torch.int32) != (a / r).view(torch.int32)).sum())
    return bad


def run(name):
    import torch

    bind(OUT / name / "lib.so")
    from picha_tpu_torch.ops import instance_norm as inm

    dev = torch.device("cuda", 0)
    ok, bits = check(inm, dev)
    res = {"name": name, "ok": ok, "bits": bits, "division_mismatches": division_mismatches(dev),
           "build_stem": inm.kernel_info(224 * 224, 64), "ms": {}}
    g = torch.Generator(device=dev).manual_seed(0)
    sums = [0.0, 0.0]
    for (h, w, c), calls in CALLS.items():
        x = torch.randn((256, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        sc = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
        dy = torch.randn((256, h, w, c), generator=g, device=dev).to(torch.bfloat16)
        y, mu, sg = inm.norm_relu_k25(x, sc)
        t = [timed(lambda: inm.norm_relu_k25(x, sc)),
             timed(lambda: inm.norm_relu_backward(x, y, dy, sc, mu, sg))]
        res["ms"][f"{h}x{w}x{c}"] = t
        sums = [s + calls * v for s, v in zip(sums, t)]
        if h == 224:
            res["k25_kernels_ms"] = kernel_ms(lambda: inm.norm_relu_k25(x, sc))
            res["k26_kernels_ms"] = kernel_ms(
                lambda: inm.norm_relu_backward(x, y, dy, sc, mu, sg))
        del x, dy, y
        torch.cuda.empty_cache()
    res["sum_12_calls_ms"] = sums
    print("RESULT " + json.dumps(res), flush=True)


def main(argv):
    sys.path.insert(0, str(ROOT))
    if len(argv) == 3 and argv[1] == "--run":
        return run(argv[2])
    out = None
    if len(argv) > 2 and argv[1] == "--json":
        out, argv = pathlib.Path(argv[2]).resolve(), argv[2:]
    names = argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(__doc__, f"unknown variants: {unknown}", file=sys.stderr)
        return 2
    builds = [(n, *prepare(n)) for n in names]
    failed = False
    for n, _d, p in builds:
        log = p.communicate()[0]
        if p.returncode:
            failed = True
            print(n, "build failed", log[-3000:], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for n, _d, p in builds:
        if p.returncode:
            continue
        r = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--run", n],
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                           capture_output=True, text=True, timeout=600)
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        if r.returncode or not line:
            failed = True
            print(n, "failed", r.returncode, r.stderr[-3000:], flush=True)
            continue
        runs.append(json.loads(line[0][7:]))
        print(line[0][7:], flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
