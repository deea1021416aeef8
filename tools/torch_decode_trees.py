#!/usr/bin/env python3
"""Run chip_smoke.py's batched-decode phases (11-12: K13-K16 against their
plain versions, then `TiffBatchPipeline` / `PngBatchPipeline` end to end
beside Pillow) and K13's buckets for several checkouts in turns on one
CUDA card.

    python3 tools/torch_decode_trees.py [--json OUT] [--k13-only] LABEL=PATH ...

Each LABEL=PATH is a checkout of this repository (its root directory);
list them in the order to run, e.g. `old=a new=. new=. old=a`. Each run
is a process of its own in that checkout: it builds the checkout's
kernels and calls its own `chip_smoke.decode_phases`, whose phase lines
(the kernels' times and builds, the stage breakdown through the
pipelines' `mark` hook, end to end and Pillow's decode of the same 256
files on 8 threads) are printed with the label; then it runs the
checkout's `png_unfilter` on the K13 buckets of this script's own
`chip_smoke.k13_bucket_records` (the same files for every checkout:
digests, equality with the sources and the plain version, ms, bounds
and the checkout's `kernel_info`). --k13-only skips decode_phases.
Prints the card's name and power limit first; with --json, also writes
the phase lines to OUT.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time


TOOL_ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(label, k13_only=False):
    """One checkout, imported from the working directory."""
    import torch

    import chip_smoke
    from picha_tpu_torch.kernels import _build
    from picha_tpu_torch.runtime import card_id

    dev = torch.device("cuda", 0)
    card = card_id()
    _build.library()

    def phase(name, **kv):
        print("PHASE " + json.dumps({"label": label, "phase": name, **kv}),
              flush=True)

    def wall(fn, reps):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return sorted(ts)[len(ts) // 2]

    if not k13_only:
        launches = chip_smoke.decode_phases(dev, card, {}, phase,
                                            chip_smoke.timed, wall)
        phase("launches", **launches)
    from picha_tpu_torch.ops import png_unfilter as k13

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_buckets", TOOL_ROOT / "chip_smoke.py")
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    phase("K13_buckets", card=card, buckets=own.k13_bucket_records(
        dev, k13.png_unfilter, chip_smoke.timed,
        getattr(k13, "kernel_info", None)))
    return 0


def main(argv):
    if len(argv) >= 3 and argv[1] == "--run":
        return run(argv[2], "--k13-only" in argv[3:])
    out = None
    if len(argv) > 2 and argv[1] == "--json":
        out, argv = pathlib.Path(argv[2]).resolve(), argv[2:]
    k13_only = len(argv) > 1 and argv[1] == "--k13-only"
    if k13_only:
        argv = argv[1:]
    trees = [a.split("=", 1) for a in argv[1:]]
    if not trees or any(len(t) != 2 for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    lines, failed = [], False
    for label, path in trees:
        root = pathlib.Path(path).resolve()
        p = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--run",
             label] + (["--k13-only"] if k13_only else []), cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root)),
            capture_output=True, text=True, timeout=1200)
        got = [json.loads(x[6:]) for x in p.stdout.splitlines()
               if x.startswith("PHASE ")]
        if p.returncode:
            failed = True
            print(label, "failed", p.returncode, p.stdout[-2000:],
                  p.stderr[-4000:], flush=True)
        for g in got:
            print(json.dumps(g), flush=True)
        lines += got
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "phases": lines}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
