#!/usr/bin/env python3
"""Time the port's tiled attention kernels (K18 forward, K22 backward) of
several checkouts in turns on one CUDA card.

    python3 tools/torch_attention_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, at
phase 23's shape (N = 16, S = 576, H = 6, D = 128) and ViT-S/16's at
384^2 (N = 128, S = 576, H = 6, D = 64), on the same seeded inputs,
forces the tiled builds and reports: a digest of K18's and K22's output
bits, their CUDA-event times (medians of 3 rounds of 10 / 5 launches), K22's
time by kernel (torch.profiler), their builds (`kernel_info`), SDPA's
forward and backward times, and,
where the checkout's `attention_backward` takes a `dp_route`, each
route's time and whether it gives the same bits. Prints the card's name
and power limit, then one JSON line a run; with --json, also writes them
all to OUT.
"""
import hashlib
import inspect
import json
import os
import pathlib
import subprocess
import sys
import time

SHAPES = {"phase23": (16, 576, 6, 128), "vit_s384": (128, 576, 6, 64)}


def timed(fn, reps, rounds=3):
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
    """Device ms of each CUDA kernel one call of fn launches
    (torch.profiler; "not measured" where it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = {e.key[:60]: e.device_time_total / 1e3
               for e in prof.key_averages() if e.device_time_total > 0}
    except Exception as exc:     # the profiler is the card machine's
        return f"not measured ({type(exc).__name__})"
    return got or "not measured"


def digest(t):
    import torch

    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def run(label):
    """One checkout, imported from the working directory."""
    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    _build.library()
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    routes = "dp_route" in inspect.signature(att.attention_backward).parameters
    dev = torch.device("cuda", 0)
    for name, (n, s, h, d) in SHAPES.items():
        g = torch.Generator().manual_seed(12)
        qkv = (2.0 * torch.randn((n, s, 3, h, d), generator=g)).to(
            torch.bfloat16).to(dev)
        do = torch.randn((n, s, h * d), generator=g).to(torch.bfloat16).to(dev)
        scale = d ** -0.5
        o = att.attention_k18(qkv, scale, force_tiled=True)
        dq = att.attention_backward(qkv, do, scale, force_tiled=True)
        r = dict(
            k18_bits=digest(o), k22_bits=digest(dq),
            k18_ms=timed(lambda: att.attention_k18(qkv, scale,
                                                   force_tiled=True), 10),
            k22_ms=timed(lambda: att.attention_backward(
                qkv, do, scale, force_tiled=True), 5),
            k18_build=att.kernel_info(s, d, force_tiled=True),
            k22_build=att.kernel_info(s, d, backward=True, force_tiled=True))
        r["k22_kernels_ms"] = kernel_ms(lambda: att.attention_backward(
            qkv, do, scale, force_tiled=True))
        for route in ("store", "recompute") if routes else ():
            got = att.attention_backward(qkv, do, scale, dp_route=route)
            r[f"k22_{route}"] = dict(
                same_bits=bool(torch.equal(got, dq)),
                ms=timed(lambda: att.attention_backward(
                    qkv, do, scale, dp_route=route), 5),
                build=att.kernel_info(s, d, backward=True, dp_route=route))
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        og = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        gout = do.view(n, s, h, d).transpose(1, 2)
        r["sdpa_ms"] = timed(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 10)
        r["sdpa_backward_ms"] = timed(lambda: torch.autograd.grad(
            og, (qg, kg, vg), gout, retain_graph=True), 5)
        res[name] = r
        del qkv, do, o, dq, og, qg, kg, vg
        torch.cuda.empty_cache()
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
            continue
        runs.append(json.loads(line[0][7:]))
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
