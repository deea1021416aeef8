#!/usr/bin/env python3
"""Time the port's ViT LayerNorm backward (K21), with its forward (K17)
for reference, of several checkouts in turns on one CUDA card.

    python3 tools/torch_layernorm_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, on
seeded bf16 rows at the shapes of the ViT-S/16 step at N = 256 (50,176 x
384) and of the ViT-S/384 step at N = 128 (73,728 x 384), reports: a
digest of K21's dx, dscale and dbias bits; their errors against
`layer_norm_backward_plain` (dx in bf16 ulps and past 1 ulp + 2^-16 of
its row's largest |dx|, dscale / dbias against the sum of their terms'
magnitudes); CUDA-event medians of K21 and K17; K21's device time split
by kernel name (torch.profiler); the bound (x, dy and dx over 3.35
TB/s); `F.layer_norm`'s autograd backward as the one-call yardstick;
K17's output digest (with a seeded bias), its device time by kernel
name (torch.profiler: the call's CUDA-event time includes the wrapper's
host time at these sizes), its bound (x and its output) and
`F.layer_norm`'s forward as its yardstick;
`ops.layernorm.kernel_info` where the checkout has it, and `nvcc -Xptxas
-v` of the checkout's `vit_layernorm_bwd.cu`; then the dense and MoE
`make_train_step` at N = 256 (medians of 5). The main process compares
every run's dx at 50,176 x 384 with the first run's and prints the count
of values that differ. Prints the card's name and power limit, then one
JSON line a run; with --json, also writes them all to OUT.
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

SHAPES = {"vit_s16_n256": (50176, 384), "vit_s384_n128": (73728, 384)}
STEP_N = 256
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


def median_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[reps // 2]


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


def digest(*ts):
    import torch

    h = hashlib.sha256()
    for t in ts:
        t = t.contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rows_of(rows, d, seed, dev):
    """Seeded (x, scale, dy): x of mean 0.5 and spread 2, dy of 0.01."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = (0.5 + 2.0 * torch.randn((rows, d), generator=g)).to(torch.bfloat16)
    scale = 1.0 + 0.3 * torch.randn(d, generator=g)
    dy = (0.01 * torch.randn((rows, d), generator=g)).to(torch.bfloat16)
    return x.to(dev), scale.to(dev), dy.to(dev)


def errors(ln, x, scale, dy, got):
    """K21's result against the plain version, in float64."""
    want = ln.layer_norm_backward_plain(x, scale, dy)
    g, w = got[0].double(), want[0].double()
    diff = (g - w).abs()
    m = g.abs().maximum(w.abs()).clamp_min(2.0 ** -126)
    ulp = (m.log2().floor() - 7).exp2()
    out = dict(dx_max_ulps=float((diff / ulp).max()),
               dx_over=float((diff - ulp - 2.0 ** -16 * w.abs().amax(
                   -1, keepdim=True)).max()),
               dx_differ_from_plain=int((got[0] != want[0]).sum()))
    x64 = x.double()
    xhat = (x64 - x64.mean(-1, keepdim=True)) / x64.std(
        -1, unbiased=False, keepdim=True)
    for key, i, terms in (("dscale", 1, xhat * dy.double()),
                          ("dbias", 2, dy.double())):
        err = (got[i].double() - want[i].double()).abs()
        out[key + "_err"] = float(
            (err / terms.abs().sum(0).clamp_min(1e-30)).max())
    return out


def run(label, save):
    """One checkout, imported from the working directory."""
    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.models import vit as vm
    from picha_tpu_torch.ops import layernorm as ln

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "shapes": {}}
    for name, (rows, d) in SHAPES.items():
        x, scale, dy = rows_of(rows, d, 7, dev)
        got = ln.layer_norm_backward(x, scale, dy)
        again = ln.layer_norm_backward(x, scale, dy)
        r = dict(rows=rows, dim=d, bits=digest(*got),
                 repeat_identical=all(bool(torch.equal(a, b))
                                      for a, b in zip(got, again)),
                 **errors(ln, x, scale, dy, got))
        if name == "vit_s16_n256":
            torch.save([t.cpu() for t in got], os.path.join(save, "dx.pt"))
        r["k21_ms"] = timed(lambda: ln.layer_norm_backward(x, scale, dy))
        r["k21_by_kernel"] = by_kernel(
            lambda: ln.layer_norm_backward(x, scale, dy))
        r["k17_ms"] = timed(lambda: ln.layer_norm_k17(
            x, scale, torch.zeros_like(scale)))
        bias = 0.2 * torch.randn(d, generator=torch.Generator().manual_seed(
            d)).to(dev)
        r["k17_bits"] = digest(ln.layer_norm_k17(x, scale, bias))
        r["k17_by_kernel"] = by_kernel(lambda: ln.layer_norm_k17(x, scale,
                                                                 bias))
        r["k17_bound_ms"] = (2 * rows * d * 2 + 2 * d * 4) / HBM * 1e3
        wb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        r["k17_library_ms"] = timed(lambda: F.layer_norm(x, (d,), wb, bb,
                                                         ln.EPS))
        r["k21_bound_ms"] = (3 * rows * d * 2 + 3 * d * 4) / HBM * 1e3
        xl = x.detach().clone().requires_grad_()
        wl = scale.to(torch.bfloat16).requires_grad_()
        bl = torch.zeros_like(wl).requires_grad_()
        out = F.layer_norm(xl, (d,), wl, bl, ln.EPS)
        r["library_ms"] = timed(lambda: torch.autograd.grad(
            out, (xl, wl, bl), dy, retain_graph=True))
        if hasattr(ln, "kernel_info"):
            r["kernel_info"] = ln.kernel_info(rows, d)
        res["shapes"][name] = r
        del x, dy, got, again, xl, out
        torch.cuda.empty_cache()
    res["ptxas"] = ptxas(pathlib.Path.cwd(), "vit_layernorm_bwd.cu")
    g = torch.Generator().manual_seed(0)
    images = torch.rand((STEP_N, 224, 224, 3), generator=g).to(dev)
    labels = torch.randint(0, 1000, (STEP_N,), generator=g).to(dev)
    for key, cfg in (("dense", vm.ViTConfig()),
                     ("moe", vm.ViTConfig(moe_experts=4))):
        params = vm.init_params(cfg, torch.Generator().manual_seed(1), dev)
        init_opt, step = vm.make_train_step(cfg, 1e-3, dev)
        box = [params, init_opt(params)]

        def one():
            box[0], box[1], _ = step(box[0], box[1], images, labels)
        res[f"{key}_step_ms"] = median_ms(one)
        del params, box
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(res), flush=True)


def main(argv):
    if len(argv) == 4 and argv[1] == "--run":
        return run(argv[2], argv[3])
    out = None
    if len(argv) > 2 and argv[1] == "--json":
        out, argv = pathlib.Path(argv[2]).resolve(), argv[2:]
    trees = [a.split("=", 1) for a in argv[1:]]
    if not trees or any(len(t) != 2 for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    runs, failed, first = [], False, None
    root_of_tool = pathlib.Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory(dir=root_of_tool) as tmp:
        for i, (label, path) in enumerate(trees):
            root = pathlib.Path(path).resolve()
            save = os.path.join(tmp, str(i))
            os.makedirs(save)
            p = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--run", label, save], cwd=root,
                env=dict(os.environ, PYTHONPATH=str(root)),
                capture_output=True, text=True, timeout=1200)
            line = [x for x in p.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if p.returncode or not line:
                failed = True
                print(label, "failed", p.returncode, p.stdout[-2000:],
                      p.stderr[-4000:], flush=True)
                continue
            runs.append(json.loads(line[0][7:]))
            got = torch.load(os.path.join(save, "dx.pt"))
            if first is None:
                first = (label, got)
            runs[-1]["vs_first_run"] = dict(
                label=first[0], **{k: int((a != b).sum()) for k, a, b in zip(
                    ("dx_differ", "dscale_differ", "dbias_differ"),
                    got, first[1])},
                dscale_max_abs=float((got[1] - first[1][1]).abs().max()),
                dbias_max_abs=float((got[2] - first[1][2]).abs().max()))
            print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
