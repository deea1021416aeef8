#!/usr/bin/env python3
"""Time the port's ResNet instance-norm kernels (K25 forward, K26
backward) of several checkouts in turns on one CUDA card.

    python3 tools/torch_norm_trees.py [--json OUT] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a` for a
comparison within one call. Each run is a process of its own that
imports the checkout's `picha_tpu_torch`, builds its kernels and, on
seeded inputs at each of the 12 calls of a `ResNetConfig()` forward at
N = 256 (the stem's (224, 224, 64), four of (112, 112, 64), four of (56,
56, 128), three of (28, 28, 256)), reports for each call: a digest of
K25's (y, mu, sigma) and K26's (dx, dscale) bits, their errors against
the plain versions (mu against the plane's mean |x|, sigma relative, y
the plain elementwise pass on K25's own statistics, dx in bf16 ulps and
past 1 ulp + 2^-16 of its plane's largest, dscale against the sum of its
terms' magnitudes), CUDA-event medians of both kernels, their bounds
(bytes over 3.35 TB/s: K25 x and y, K26 x, dy and dx), and the one-call
yardsticks `F.instance_norm` + relu and its autograd; then the builds
(`kernel_info`, where the checkout has it), and `ResNet(ResNetConfig())`
forward and `train_step` ms at N = 256 (medians of 5). Prints the card's
name and power limit, then one JSON line a run; with --json, also writes
them all to OUT.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

N = 256
CALLS = [(224, 224, 64)] + [(112, 112, 64)] * 4 + [(56, 56, 128)] * 4 + \
    [(28, 28, 256)] * 3
HBM = 3.35e12


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


def digest(*ts):
    import torch

    h = hashlib.sha256()
    for t in ts:
        t = t.contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def errors(inm, x, scale, dy, y, mu, sg, dx, ds):
    """The K25 / K26 results against the plain versions, 32 images at a
    time in float64."""
    import torch

    wy, wmu, wsg = inm.norm_relu_plain(x, scale)
    wdx, wds = inm.norm_relu_backward_plain(x, y, dy, scale, mu, sg)
    out = dict(y_is_elementwise=bool(torch.equal(
        y, inm.normalize_relu(x, scale, mu, sg))), mu_err=0.0, sigma_err=0.0,
        dx_max_ulps=0.0, dx_over=-1.0)
    terms = torch.zeros(x.shape[3], dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], 32):
        sl = slice(i, i + 32)
        xd = x[sl].double()
        out["mu_err"] = max(out["mu_err"], float(
            ((mu[sl] - wmu[sl]).double().abs()
             / xd.abs().mean((1, 2)).clamp_min(1e-30)).max()))
        out["sigma_err"] = max(out["sigma_err"], float(
            ((sg[sl] - wsg[sl]).double().abs() / wsg[sl].double()).max()))
        g, w = dx[sl].double(), wdx[sl].double()
        diff = (g - w).abs()
        m = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        u = torch.exp2(torch.floor(torch.log2(m)) - 7)
        out["dx_max_ulps"] = max(out["dx_max_ulps"], float((diff / u).max()))
        out["dx_over"] = max(out["dx_over"], float(
            (diff - u - 2.0 ** -16 * w.abs().amax((1, 2), keepdim=True))
            .max()))
        xhat = (xd - mu[sl].double()[:, None, None, :]) / \
            sg[sl].double()[:, None, None, :]
        terms += (xhat * dy[sl].double() * (y[sl] > 0)).abs().sum((0, 1, 2))
        del xd, g, w, diff, m, u, xhat
    out["dscale_err"] = float(((ds.double() - wds.double()).abs()
                               / terms.clamp_min(1e-30)).max())
    return out


def run(label):
    """One checkout, imported from the working directory."""
    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.models import resnet as rn
    from picha_tpu_torch.ops import instance_norm as inm

    t0 = time.perf_counter()
    _build.library()
    res = {"label": label, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "calls": []}
    dev = torch.device("cuda", 0)
    for i, (h, w, c) in enumerate(CALLS):
        g = torch.Generator().manual_seed(100 + i)
        x = (0.5 + 2.0 * torch.randn((N, h, w, c), generator=g)).to(
            torch.bfloat16).to(dev)
        scale = 1.0 + 0.3 * torch.randn(c, generator=g)
        scale[::3] = -scale[::3]
        scale = scale.to(dev)
        dy = torch.randn((N, h, w, c), generator=g).to(torch.bfloat16).to(dev)
        y, mu, sg = inm.norm_relu_k25(x, scale)
        dx, ds = inm.norm_relu_backward(x, y, dy, scale, mu, sg)
        r = dict(shape=[N, h, w, c], k25_bits=digest(y, mu, sg),
                 k26_bits=digest(dx, ds),
                 **errors(inm, x, scale, dy, y, mu, sg, dx, ds))
        r["k25_ms"] = timed(lambda: inm.norm_relu_k25(x, scale))
        r["k26_ms"] = timed(lambda: inm.norm_relu_backward(
            x, y, dy, scale, mu, sg))
        r["k25_bound_ms"] = x.numel() * 4 / HBM * 1e3
        r["k26_bound_ms"] = x.numel() * 6 / HBM * 1e3
        r["k26_bound_ms_with_y"] = x.numel() * 8 / HBM * 1e3
        xl = x.permute(0, 3, 1, 2)
        r["library_k25_ms"] = timed(lambda: torch.relu(F.instance_norm(
            xl, weight=scale, eps=inm.EPS)))
        xg = xl.detach().requires_grad_()
        wg = scale.detach().clone().requires_grad_()
        out = torch.relu(F.instance_norm(xg, weight=wg, eps=inm.EPS))
        gl = dy.permute(0, 3, 1, 2)
        r["library_k26_ms"] = timed(lambda: torch.autograd.grad(
            out, (xg, wg), gl, retain_graph=True))
        res["calls"].append(r)
        del x, dy, y, dx, xl, xg, out, gl
        torch.cuda.empty_cache()
    for k in ("k25_ms", "k26_ms", "k25_bound_ms", "k26_bound_ms",
              "library_k25_ms", "library_k26_ms"):
        res[f"sum_{k}"] = sum(r[k] for r in res["calls"])
    if hasattr(inm, "kernel_info"):
        res["builds"] = {f"{h * w},{c}": inm.kernel_info(h * w, c)
                         for h, w, c in sorted(set(CALLS))}
    else:
        res["builds"] = "not available in this checkout"
    g = torch.Generator().manual_seed(0)
    images = torch.rand((N, 224, 224, 3), generator=g).to(dev)
    labels = torch.randint(0, 1000, (N,), generator=g).to(dev)
    model = rn.ResNet(rn.ResNetConfig(), seed=0, device=dev)
    res["forward_ms"] = median_ms(lambda: model(images))
    init_opt, step = rn.make_train_step(model.cfg, 1e-3, dev)
    box = [model.params(), None]
    box[1] = init_opt(box[0])

    def one():
        box[0], box[1], _ = step(box[0], box[1], images, labels)
    res["step_ms"] = median_ms(one)
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
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if k not in ("calls", "builds")}), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
