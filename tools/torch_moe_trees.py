#!/usr/bin/env python3
"""Time the port's MoE route + dispatch (K19) of several checkouts in
turns on one CUDA card.

    python3 tools/torch_moe_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, on
seeded router logits (t, 4) float32 and rows (t, 384) bfloat16 (every
fifth row with -0 entries) at cap = capacity(t, 4, 1.5), the shapes of
the MoE ViT-S forward on 256 images:

  forward  t = 50,176 (256 x 196 tokens), normal logits;
  skewed   the same with every token routed to expert 0 (drops past cap);
  odd      t = 50,175, a count that is no multiple of any tile;

reports: a digest of (xe, eidx, sidx, gk) (which must match across
checkouts), equality with `route_dispatch_plain` on the card, the kept
tokens, CUDA-event ms of the K19 call (`route_dispatch_k19`), the
call's kernels by name (torch.profiler; memsets under their own name),
the bound (the logits and rows read once, the (E, cap, d) buffer and
the three (t,) outputs written once, over 3.35 TB/s) and
`ops.moe.kernel_info` where the checkout has it; then the MoE ViT-S
forward (`ViTConfig(moe_experts=4)`, seed 1) on 256 seeded images
(CUDA-event ms over 10 forwards) and `nvcc -Xptxas -v` of the
checkout's `vit_moe.cu`. Prints the card's name and power limit, then
one JSON line a run; with --json, also writes them all to OUT. The main
process checks every run's digests against the first run's.
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
EXPERTS, DIM, CF = 4, 384, 1.5
# name -> (tokens, router)
SHAPES = {"forward": (50176, "normal"), "skewed": (50176, "skewed"),
          "odd": (50175, "normal")}


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
            # the profiler may miss a launch of the window: ms a launch
            row["ms_a_launch"] = row["ms"] / row["launches"]
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
    import torch

    h = hashlib.sha256()
    for t in ts:
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def inputs(t, router, dev):
    import torch

    g = torch.Generator().manual_seed(t)
    logits = torch.randn((t, EXPERTS), generator=g)
    if router == "skewed":          # every token on expert 0
        logits[:, 0] = logits.amax(-1) + 1.0
    y = (torch.randn((t, DIM), generator=g) * 2.0).to(torch.bfloat16)
    y[::5, ::3] = -0.0
    return logits.to(dev), y.to(dev)


def bits_equal(a, b):
    import torch

    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def run(label):
    """One checkout, imported from the working directory."""
    import torch

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.ops import moe

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "shapes": {}}
    for name, (t, router) in SHAPES.items():
        logits, y = inputs(t, router, dev)
        cap = moe.capacity(t, EXPERTS, CF)
        got = moe.route_dispatch_k19(logits, y, cap)
        want = moe.route_dispatch_plain(logits, y, cap)
        xe, eidx = got[0], got[1]
        r = dict(tokens=t, experts=EXPERTS, dim=DIM, cap=cap,
                 kept=int((eidx < EXPERTS).sum()), bits=digest(got),
                 equal_plain=all(bits_equal(a, b) for a, b in zip(got, want)))
        r["ms"] = timed(lambda: moe.route_dispatch_k19(logits, y, cap))
        r["by_kernel"] = by_kernel(lambda: moe.route_dispatch_k19(
            logits, y, cap))
        r["bound_ms"] = (logits.numel() * 4 + y.numel() * 2
                         + xe.numel() * 2 + t * 12) / HBM * 1e3
        if hasattr(moe, "kernel_info"):
            r["kernel_info"] = moe.kernel_info(t, EXPERTS, DIM, dev)
        res["shapes"][name] = r
        del logits, y, got, want, xe, eidx
        torch.cuda.empty_cache()
    from picha_tpu_torch.models.vit import ViT, ViTConfig

    model = ViT(ViTConfig(moe_experts=EXPERTS), seed=1, device=dev)
    images = torch.rand((256, 224, 224, 3),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        logits = model(images)
        res["moe_forward_ms"] = timed(lambda: model(images), reps=10)
    res["moe_forward_logits_bits"] = digest([logits])
    res["ptxas"] = ptxas(pathlib.Path.cwd(), "vit_moe.cu")
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
        bits = {s: r["bits"] for s, r in runs[-1]["shapes"].items()}
        bits["moe_forward"] = runs[-1]["moe_forward_logits_bits"]
        first = first or dict(label=label, bits=bits)
        same = {k: v == first["bits"][k] for k, v in bits.items()}
        runs[-1]["same_bits_as_first_run"] = dict(label=first["label"],
                                                  **same)
        failed |= not all(same.values()) or not all(
            r["equal_plain"] for r in runs[-1]["shapes"].values())
        print(json.dumps(runs[-1]), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
