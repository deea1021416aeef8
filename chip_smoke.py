#!/usr/bin/env python3
"""Chip smoke test of picha_tpu_torch, the PyTorch/CUDA port: drives the
all-device JPEG transcode paths (fused and staged pixel stages, the scan
upload and the five host-coefficient uploads, the four encode backends:
device, tpu, raw420, host), the training ingest, the pixel-array path (BASELINE config 4, the
single-image resize and convert, the batched PNG encode), the batched
PNG and TIFF decode, the ViT-S/16 forward and train step (dense and
switch-MoE) and the ResNet forward and train step, both fed by the
ingest, model configurations past the tuned kernels' shapes and the
ViT-S/16 widths at 384^2 at full depth, on one CUDA card, and checks
them.

    python3 chip_smoke.py        # from the repository root, one card

Phases (each prints one line; any failure raises and exits non-zero):
  1. the card (nvidia-smi name, power limit); build kernels K1-K31 (and
     the host C++ decoder, packers and JPEG writer) from
     picha_tpu_torch/csrc/ (one nvcc per source, in parallel) into the
     gitignored csrc/build/;
  2. each kernel against its plain torch version on the card, at the
     main path's shapes (16 x 1920x1088 -> 960x544 q85): K1-K3 on the
     restart-8 corpus (K1 also on 16 of its sources re-encoded with
     optimize=True, each with its own tables, and its longest lane
     alone: the chain's floor in ns a symbol; its build and plan; K2's
     and K3's builds and plans, K3's device time by kernel beside its
     call), the chunked decoder K4 and its DC scan K5 on the
     same pixels encoded without restart markers, where K4 must also
     give K1's coefficients exactly; the staged decode's K6 (dequant +
     IDCT; off by one only at near-.5 ties) and K7 (upsample + colour,
     exact; its build, and its other compiled-in signatures, 4:2:2,
     4:4:4, grey and grey to rgb, on 16 random 1080p planes) on K1's
     coefficients, and K8 on K7's output: its per-axis kernels (the
     width and the height pass) exactly their windowed twins and within
     1e-6 of the reference's banded plan, and its one-launch kernel
     (both axes, the staged path's) exactly the two twins, timed beside
     the two passes, with its route, tile and builds;
  3. the slice end to end through JpegBatchPipeline(width=960,
     height=544, encode_quality=85, encode_backend="device", fused=True,
     upload="scan") on the restart corpus: every output decodes, sits
     <=1 LSB (mean) from the strict host path's output (libjpeg decode ->
     native resize -> libjpeg encode, committed under
     tests/fixtures/port/ because the card machine has no libjpeg for
     the native library), is byte for byte the port's plain-torch path's
     output, takes no fallback, and launched every kernel of its path;
     then the same on the corpus without restart markers, whose outputs
     must equal the restart corpus's byte for byte, through K4 and K5
     and not K1;
     then the staged slice (fused=False: K6 -> K7 -> K8 in one launch
     -> K2 -> K3) on both corpora, with the same checks (its restart and
     no-restart outputs byte-identical), and the staged decode-only
     output (encode_quality=None) against Pillow's decode of the sources;
  4. phase 3's restart slice again with TF32 matmuls allowed globally;
  5. timing with CUDA events: kernel path vs plain path, end to end and
     device-only (upload resident, decode->encode, byte-count readback),
     for both corpora and both pixel paths, and where one batch's time
     goes, stage by stage;
  6. the training ingest, TrainingInput(batch=256, crop=192, size=224,
     augment=brightness/contrast/saturation .2 + 32-px cutout) over 256
     1920x1088 q85 JPEGs without restart markers: K9 (crop + flip + both
     resize passes in one launch, resize_2d's crop mode; bitwise the
     plain chain and its per-axis route, K9's width pass then K8's
     height pass; with its plan and build, timed beside that route) and
     K10 (clip + augment; within 1e-6 of its twin and bit for bit the
     twin on its lane-order model's contrast mean, with its plan and
     builds, and timed with contrast off) at that shape;
     three steps, each checked for shape, range, zero fallbacks, the launches
     of K4, K5, K6, K7, K9 and K10 (and none of the per-axis route), and
     against the same draws through the plain chain; the second step
     resumed from state() bit for bit; a fourth step without augment
     held to a host anchor (Pillow decode, the host-drawn window, the
     port's flip, the CPU windowed resize) within 1/255 mean; one
     pre_crop=False step on 16 images; one step of 16 on the per-axis
     route (crop 1024 -> 64, windows no tile holds), where K9's width
     pass and K8's per-axis kernel run;
  7. the ingest's timing: ms per step by stage (host parse and draws,
     wire, upload; K4, K5, split, K6 a component, K7, K9, K10, a CUDA
     event each), images/s, peak device memory;
  8. the pixel-array kernels against their plain versions at the path's
     shapes, bit for bit: K11 (unpack, crop window, channel map, pack)
     as the config-4 call's head ((256, 256, 384, 4) uint8, crop
     (16, 16, 352, 224) -> float32) and tail ((256, 112, 176, 4) float32
     -> uint8, and clipped for normalize), and as convert_batch on 16 x
     1920x1088 (rgba -> greya, r16g16b16a16 -> r16); K12 (PNG encode
     filters) on (256, 112, 704) rows, bpp 4: the probe's streams 2, 1,
     -1 in one launch, and strategies -1, 1, 2 alone, with its plan and
     build;
  9. BASELINE config 4 through ImageBatchPipeline(crop=(16, 16, 352,
     224), resize=(176, 112)): 256 RGBA 384x256 sources (bench.py's
     recipe, seed 9, 8 images tiled) TIFF-LZW encoded with Pillow,
     decoded on pool threads, K11 -> K8 (one launch) -> K11 on the card,
     encoded as TIFF LZW and as WebP q85: every output decodes to
     176x112 RGBA, the TIFFs to exactly the pixels of the same call on
     CPU tensors (the plain path), the WebPs within 8 LSB mean (the
     reference's lossy oracle), K11 twice and K8 once, no jax
     or picha_tpu module loaded; resize_batch (16 x 1920x1088 rgb ->
     960x544 lanczos) and convert_batch (rgb -> grey) bit for bit their
     plain paths on the card; encode_filtered on the 256 outputs: one
     K12 launch, every file decoding to its input;
 10. where a config-4 call's time goes (host decode, upload, K11 head,
     K8, K11 tail, readback, host TIFF encode), Mpix/s of source
     and images/s (TIFF and WebP legs), the idle share, and the PNG
     encode's K12 launch against its readback and host deflate;
 11. the decode kernels against their plain versions, bit for bit, on
     config 4's 256 sources: K15 (LZW strips) on their TIFF-LZW files
     (Pillow's writer, 7 strips each; the pure-Python twin on the 8
     distinct images; rows, lengths and statuses), also timed on the
     predictor-2 orientation-6 files and on compressible files (the
     sources without noise, 8 levels a channel; rows equal to them), the
     twin on 2 images each, with K15's build; K16 (TIFF transform) on
     the rows, K13 (unfilter)
     on their PNGs (the port's encode, default probe; the twin on the 8
     distinct images; with its build, and its buckets: the sources
     encoded with strategies 4, 3 and 2, as rgb8, rgb16 and rgba16, and
     one 1920x1088 rgb8 image, each equal to its sources and to the twin
     on 32 rows of 2 images), K14 (PNG transform) on the samples. Both
     transforms are the identity on these rgba buckets, so a clone of
     their input is their one-call yardstick; K16 is also timed on the
     same sources written with predictor 2 and orientation 6 and on the
     rows as a view at byte offset 5, K14 on a palette + tRNS bucket and
     on the sources as 16-bit rgb decoded deep; each with the build of
     the kernel it launches (registers, spills, shared bytes, blocks an
     SM);
 12. TiffBatchPipeline over the 256 TIFF-LZW files (K15 and K16 once
     each, nothing else; equal to image_host.decode_tiff of each file
     and to the sources) and over their predictor-2 orientation-6 twins
     (equal to the turned sources), PngBatchPipeline over the 256 PNGs
     (K13 and K14 once each; equal to the sources), a 16-bit rgb bucket
     (the sources x 257 through the 16-bit encode, decoded deep, exact)
     and a palette bucket with tRNS (equal to Pillow's decode); where
     each call's time goes (host stage, pack, upload, each kernel, the
     status readback, timed through the decode functions' `mark` hook)
     with the bytes uploaded and its end-to-end time beside Pillow's
     decode of the same 256 files on 8 pool threads;
 13. one TrainingInput step (phase 6's arguments, 256 images) fed to
     ViT(ViTConfig()) (ViT-S/16: 224^2, patch 16, dim 384, 12 blocks of 6
     heads, MLP 1536, 1000 classes; random weights from seed 0) and to
     ViT(ViTConfig(moe_experts=4)) (every second block a switch MoE of 4
     experts, capacity 1.5; seed 1). K17 (LayerNorm; also bit for bit
     its lane-order model, with its plan and build) and K18 (attention)
     within 1 bf16 ulp of their plain versions (K18: plus 1 ulp of the
     row's largest |o|), K19 (route + dispatch) and K20 (combine) bit for
     bit, each on the arguments of its first call in a forward, K19 also
     on a skewed router (every token on expert 0) that drops tokens and on
     its last call in the forward, with its build and plan
     (`ops.moe.kernel_info`); both forwards' logits (256,
     1000) float32, finite, within 0.03 plus one bf16 ulp of the logit
     (its own rounding) of the same forward through the plain versions on
     the card (the MoE's also on the kernel path's routes, as phase 15's
     gradients, and where the two route a token differently), with
     launches K17 = 25, K18 = 12 (and K19 = K20 = 6 for the MoE) and no
     other kernel; the dense forward again with TF32 and bf16 reduced-precision sums
     switched on globally, giving the same logits; K18's build as the
     card reports it (registers, spills, shared memory, resident blocks)
     and the tensor-core products (HMMA) cuobjdump finds in K18 and K22;
 14. both forwards timed on the kernel and the plain path (images/s),
     where their time goes (the forward's `mark` hook: products against
     K17-K20), peak device memory, and one ingest step + forward end to
     end with the card's idle share;
 15. one TrainingInput step (phase 6's arguments, 256 images) with labels
     from a seeded torch.Generator, for ViTConfig() (seed 0) and
     ViTConfig(moe_experts=4) (seed 1): K21 (LayerNorm backward; dx
     within 1 bf16 ulp, dscale / dbias within 1e-5 of the sum of their
     terms' magnitudes), K22 (attention backward; within 1 ulp + 1 ulp of
     the row's largest |value|), K23 (the MoE dispatch's backward) and K24
     (its combine's backward; gathers and scatters bit for bit, dlogits /
     dgk within 1e-6 relative) against their plain versions on the
     arguments of their first call in a backward (K22 on every call of
     the step: of the dense step at seeds 0 and 2 within its bound, at
     seeds 3-6 and of the MoE step past its first call held no further
     from a float64 VJP than the plain version is plus the bound, its
     excesses recorded; the plain version's f32 dP = do . v^T checked
     bit for bit against the same sums taken in order, the order K22
     re-sums its ambiguous dP values in), K23 also on a router that
     sends every token to expert 0 (K21 also timed by kernel with
     torch.profiler, beside its plan and build from
     `ops.layernorm.kernel_info`); one step's gradients through the
     kernels against the same step through the plain versions on the card
     (each leaf within 2e-2 relative L2; the MoE's routes compared); three
     steps at learning_rate=1e-3 (finite losses, the third below the
     first) with launches K17 = K21 = 25, K18 = K22 = 12 (and K19 = K20 =
     K23 = K24 = 6 for the MoE) per step and no other kernel; a checkpoint
     (models/checkpoint.py, with the ingest's state()) after step 2,
     loaded, and step 3 from it bit for bit the uninterrupted step 3; the
     dense gradients again with TF32 and bf16 reduced-precision sums on
     globally, identical;
 16. the train step timed on the kernel and the plain path (images/s),
     where it goes (forward stages, backward, optimizer through
     train_step's mark hook; the backward split into K21-K24 and the
     backward products replayed alone), peak device memory, the bound
     (3 x the forward's bf16 product FLOPs), each backward kernel's
     yardstick (F.layer_norm's backward; SDPA forward + backward and its
     backward alone; K18 and K22 also their share of the bound, their
     ratio to SDPA's forward / backward alone and K22's registers and
     spills), and one ingest step + train step end to end with the
     card's idle share;
 17. one TrainingInput step (phase 6's arguments, 256 images) with labels
     from a seeded torch.Generator into ResNet(ResNetConfig()) (224^2, a
     3x3 stem of 64, stages (64, 128, 256) of 2 blocks, 1000 classes,
     3.0 M parameters; random weights from seed 0): K25 (instance norm +
     scale + ReLU) and K26 (its backward) against their plain versions on
     the arguments of their first and last calls (the stem's output
     (256, 224, 224, 64) and the last block's (256, 28, 28, 256)): mu and
     sigma within 1e-6, y bit for bit the plain elementwise pass on K25's
     statistics and within 1 bf16 ulp of the plain y plus what the
     statistics' differences move it, dx within 1 bf16 ulp (+2^-16 of
     its plane's largest), dscale within 1e-5 of the sum of its terms'
     magnitudes; the forward's logits (256, 1000) float32, finite, within
     0.03 of the same forward through the plain versions and, like each
     gradient leaf of one step, by the float64 criterion (||kernel -
     float64|| <= 2 ||plain - float64|| + 1e-2 ||float64||, the float64
     forward and backward taken 32 images at a time); launches K25 = 12 a
     forward, K25 = K26 = 12 a step and no other kernel; the forward again
     with TF32 and bf16 reduced-precision sums on globally, identical;
     three steps at learning_rate=1e-3 (finite, the third loss below the
     first), a checkpoint after step 2 with the ingest's state(), loaded,
     and step 3 from it bit for bit;
 18. the ResNet timed: forward and train step on the kernel and the plain
     path (medians of 5, images/s), where the step goes (stem, each
     stage's convolutions, K25, residuals, head, loss, backward, AdamW
     through train_step's mark hook; the backward split into K26's 12
     calls and the convolution backwards replayed alone), each kernel's
     bound and yardstick (F.instance_norm + relu, and their autograd),
     peak device memory, and one ingest step + train step end to end with
     the card's idle share;
 19. the host-coefficient uploads' host stage on the slice's 16 sources:
     the host C++ entropy decoder (csrc/jpeg_entropy_host.cu, 8 pool
     threads) bit for bit K1's coefficients (restart corpus) and K4 +
     K5's (no restart), and the numpy decoder's on 2 sources; its batch,
     one-image segment-parallel and one-thread times;
 20. K27-K30 (csrc/coef_restore.cu: sparse densify, int8, gap8, gap4
     restores) bit for bit their plain versions and the coefficients, on
     the restart corpus's wires and on 4 of its sources re-encoded at
     q = 100 (a non-empty correction list; gap4 escapes on the corpus),
     the C++ packers' wires byte for byte the numpy packers'; timed, with
     their bounds (K27's yardstick one index_add_ per component), each
     call's device time by kernel (torch.profiler) and K29's and K30's
     tile and builds (`ops.coef_restore.kernel_info`);
 21. JpegBatchPipeline(width=960, height=544, encode_quality=85,
     encode_backend="device", fused=True|False, upload=u) for u in dense,
     sparse, int8, gap8, gap4 on both corpora: every output byte for byte
     upload="scan"'s in this run, no fallback, the restore and pixel
     kernels launched and neither device decoder; where a batch's time
     goes per upload beside scan's (host decode, pack, wire bytes,
     upload, restore on the card, end-to-end Mpix/s);
 22. F5: forward and one train step on the card (depth 2, 4 images) of
     ViTConfig(image_size=272) (289 tokens; 576 tokens is phase 29's),
     dim=768 heads=6 (head 128), dim=768 heads=3 (head 256), dim=384
     heads=2 (head 192; both through the tiled builds' wide kernels),
     dim=1280 heads=16 patch=14 (head 80,
     width 1280), dim=387 heads=9 (odd width, head 43), moe_experts=128
     moe_every=1, and ResNetConfig(stem_channels=33, stage_channels=(33,
     65), blocks_per_stage=1): logits within 0.03 + 1 bf16 ulp of the
     plain path (the MoE's on the kernel path's routes), every ViT
     gradient leaf within 2e-2 relative L2, the ResNet's by the float64
     criterion; each kernel timed at these shapes (its `buckets`);
 23. the tiled K18 and K22 at S = 576, D = 128 (N = 16, H = 6) within
     their bounds of the plain versions, timed beside SDPA (and the
     kernels SDPA launched), K22 beside a copy of its dP scratch's bytes;
     the wide kernels beside SDPA at heads 256 and 192 (N = 4, S = 196);
 24. K31 (the raw420 encode's 4:2:0 pack) bit for bit its plain version
     on the slice's 960x544 pixels, fused (float32) and staged, timed;
 25. the host C++ JPEG writer (csrc/jpeg_write_host.cu) byte for byte the
     numpy writer on 2 of the slice's K31 buffers and K2 coefficient sets,
     and libjpeg's bytes on the committed tests/fixtures/port/raw420_*
     cases; its time per image on one thread and per batch on 8;
 26. JpegBatchPipeline(encode_backend="raw420" | "tpu", fused=True|False,
     upload="scan") on the restart corpus: <= 1 LSB (mean) of the strict
     host path, no fallback, K31 (raw420) or K2 (tpu) launched and K3
     not; raw420 byte for byte the same pipeline with K31's plain version
     patched in; "tpu" the "device" backend's scan bytes behind libjpeg's
     header;
 27. a forced overflow (scan_byte_cap 16 KiB, encode_backend="device")
     redone by the reference's fallback: a raw420 clone with upload gap4
     (K30, K31), byte for byte phase 26's raw420 output;
 28. the four encode backends timed in turns on the fused restart slice:
     bytes read back, device ms, readback + host encode ms, end to end;
 29. ViTConfig(image_size=384) (ViT-S/16's widths at 384^2, 576 tokens:
     the tiled K18 / K22) at full depth on 8 random images: logits within
     0.03 + 1 bf16 ulp and every gradient leaf within 2e-2 relative L2 of
     the plain path, one train step, each kernel timed at its shapes;
 30. the same at N = 128 through ViT(cfg) and make_train_step: K18 and
     K22 launched 12 times a forward and a step (K17 / K21 25), no plain
     version and no SDPA; forward and step ms (medians of 5 CUDA-event
     timings), K18 x 12 through the mark hook, K22 x 12 by events around
     its calls, peak memory; one K18 and one K22 launch at the step's
     shapes beside SDPA, the bounds and K22's dP scratch traffic.
Every kernel also gets its bound (the larger of its bytes over 3.35 TB/s
and its FP32 FLOPs over 67 TFLOP/s plus its bf16 product FLOPs over 989
TFLOP/s, counted from this run's shapes) and, where one PyTorch call
computes the same function, that call's time. Then one JSON line of
per-kernel results, the card line, and the final JSON status line.
"""
import io
import json
import pathlib
import sys
import time
import zlib

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "port"
N_IMG, SRC_W, SRC_H, OUT_W, OUT_H, QUALITY = 16, 1920, 1088, 960, 544, 85
K2_MAX_OFF_BY_ONE = 1e-4   # f32 summation order at exact .5 ties
K6_NEAR_TIE = 1e-4         # K6 may be off by one only this close to .5
RESIZE_TOL = 1e-6          # K8 vs the reference's banded plan, 0-1 scale
PARITY_LSB = 1.0           # mean |diff| vs the strict host path
DECODE_LSB = 1.0           # staged decode-only, mean |diff| vs Pillow
TRAIN_N, CROP, SIZE = 256, 192, 224
AXIS_CROP, AXIS_SIZE = 1024, 64   # K9's per-axis route: no tile holds it
AUGMENT = {"brightness_s": .2, "contrast_s": .2, "saturation_s": .2,
           "cutout_size": 32}
K10_TOL = 1e-6             # K10 vs its twin: the contrast mean's sum order
ANCHOR_LSB = 1.0           # ingest vs the host anchor, mean, in 1/255
IMG_N, IMG_W, IMG_H = 256, 384, 256          # BASELINE config 4
IMG_CROP, IMG_OUT = (16, 16, 352, 224), (176, 112)
RC_N = 16                  # resize_convert: 16 x 1920x1088
WEBP_LSB = 8.0             # the reference's lossy oracle, mean per image
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12   # H100 SXM peaks, 700 W
BF16_FLOP_S = 989e12                         # dense bf16 tensor peak
VIT_LOGIT_TOL = 0.03       # ViT logits vs the plain path, + 1 bf16 ulp
TRAIN_LR = 1e-3            # phase 15's three train steps
GRAD_RL2 = 2e-2            # a gradient leaf vs the plain path, relative L2
RESNET_LOGIT_TOL = 0.03    # ResNet logits vs the plain path, max abs
F64_CHUNK = 32             # images per float64 ResNet forward + backward


def bound(nbytes, flops=0, bf16_flops=0):
    """The least time for the work at the card's peaks: bytes moved
    (each input read once, each output written once) over HBM, or FP32
    FLOPs over the FFMA peak plus bf16 product FLOPs over the tensor
    peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = (flops / FP32_FLOP_S + bf16_flops / BF16_FLOP_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_flops=int(flops),
                bound_bf16_flops=int(bf16_flops))


def sass_counts(lib, fragment):
    """Per kernel of the built library whose name holds `fragment`, the
    count of its tensor-core (HMMA / HGMMA) and FP32-pipe FMA (FFMA)
    instructions, from `cuobjdump -sass`."""
    import re
    import shutil
    import subprocess

    from picha_tpu_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        tool = shutil.which("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if fragment in m.group(1) else None
            if cur:
                counts[cur] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
        elif cur:
            for op in (" HGMMA.", " HMMA.", " FFMA "):
                if op in line:
                    counts[cur][op.strip(" .")] += 1
                    break
    return counts


def attention_sass(backward):
    """K18's (K22's) instantiations in the built library with their HMMA /
    HGMMA and FFMA counts; raises unless every one of them issues
    tensor-core products."""
    from picha_tpu_torch.kernels import _build

    got = {k: v for k, v in sass_counts(_build.library_path(),
                                        "vit_attention").items()
           if ("vit_attention_bwd" in k) == backward}
    if not got or not all(v["HMMA"] + v["HGMMA"] for v in got.values()):
        raise AssertionError(f"no tensor-core product in {got}")
    return got


def pinned_route_dispatch(routes):
    """K19's plain version with each call's (eidx, sidx) replaced by the
    kernel path's (`routes`, in call order): the buffer scattered and the
    gate taken at those slots, the gate the routed expert's probability.
    A router near-tie that a one-ulp move of K17 or K18 flips moves the
    token to another expert and, past capacity, which tokens drop, and a
    token's output, and its share of a router gradient, is all or
    nothing. A gradient comparison pins the backward too
    (`pinned_dispatch_backward`)."""
    import torch

    from picha_tpu_torch.ops import moe as moe_mod

    calls = iter(routes)

    def call(logits, y, cap):
        eidx, sidx = next(calls)
        experts = logits.shape[1]
        ex, s = moe_mod._softmax_parts(logits)
        keep = eidx < experts
        gate = (ex / s).gather(1, eidx.long().clamp(max=experts - 1)[:, None])
        xe = torch.zeros((experts + 1, cap, y.shape[1]), dtype=y.dtype,
                         device=y.device)
        xe.index_put_((eidx.long(), sidx.long()), y, accumulate=True)
        return xe[:experts], eidx, sidx, gate[:, 0] * keep
    return call


def pinned_dispatch_backward(dxe, eidx, sidx, logits, dgk):
    """K23's plain version (`moe.dispatch_backward_plain`) on pinned routes:
    the gate's gradient enters the softmax at the routed expert `eidx`, as
    the kernel path's does at its own logits' maximum, where the plain
    version takes the maximum of the plain path's logits, which a near-tie
    may put on another expert (a token's whole router-gradient row)."""
    import torch

    from picha_tpu_torch.ops import moe as moe_mod

    experts, cap, d = dxe.shape
    dxp = torch.cat([dxe, dxe.new_zeros((1, cap, d))])
    dy = dxp[eidx.long(), sidx.long()]
    ex, l = moe_mod._softmax_parts(logits)
    keep = (eidx < experts).to(torch.float32)
    routed = torch.nn.functional.one_hot(
        eidx.long().clamp(max=experts - 1), experts).to(torch.float32)
    dg = (dgk * keep)[:, None] * routed
    w = (dg * (l * l).reciprocal()) * ex
    c = w[:, :1]
    for i in range(1, experts):
        c = c + w[:, i:i + 1]
    return dy, ((dg / l) + -c) * ex


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


def decode_rgb(buf):
    import numpy as np
    from PIL import Image

    im = Image.open(io.BytesIO(bytes(buf)))
    im.load()
    if im.format != "JPEG" or im.size != (OUT_W, OUT_H):
        raise AssertionError(f"not a {OUT_W}x{OUT_H} JPEG: {im.format} "
                             f"{im.size}")
    return np.asarray(im.convert("RGB"), dtype=np.int32)


def decode_source(buf):
    """Pillow's (libjpeg's) full-size RGB decode of a source JPEG."""
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(bytes(buf))).convert("RGB"),
                      dtype=np.int32)


def k4_own_tables(dev, phase, timed, srcs_nr):
    """K4 + K5 on 1920x1088 no-restart JPEGs that each carry their own
    optimised Huffman tables (Pillow's optimize=True, as mozjpeg writes
    by default): 16 unique table rows, past the 96 KB of tables K4 keeps
    in shared memory, so its builds that read them from global memory
    run. Equal to the plain version: coefficients, ok and passes."""
    import torch
    from PIL import Image

    from picha_tpu_torch.ops import jpeg_huffman_decode as hd
    from picha_tpu_torch.ops.jpeg_scan import mcu_slot_tables, parse_baseline
    from picha_tpu_torch.pipeline.jpeg_batch import signature

    bufs = []
    for i, q in enumerate((80, 85, 90, 95)):
        b = io.BytesIO()
        Image.open(io.BytesIO(srcs_nr[i % 3])).save(b, "JPEG", quality=q,
                                                     optimize=True)
        bufs.append(b.getvalue())
    infos = [parse_baseline(b) for b in bufs]
    ks, wire = hd.scan_wire(infos)
    comp_sig = signature(infos[0])[3]
    comp_of = torch.as_tensor(mcu_slot_tables(comp_sig)).to(dev, torch.int32)
    args, _q = hd.wire_unpack(torch.from_numpy(wire).to(dev), ks,
                              len(comp_sig))
    build = hd.kernel_info(n_uniq=ks[7], n_lanes=ks[1])
    if ks[9] or ks[7] <= 10 or build["tables_in_shared"]:
        raise AssertionError(f"not the global-table build: {ks}")
    got, ok, passes = hd.decode_scan_chunked(args, ks, comp_of)
    want, ok_p, passes_p = hd.decode_scan_chunked_plain(args, ks, comp_of)
    torch.cuda.synchronize()
    if not (bool(ok) and bool(ok_p)) or int(passes) != int(passes_p) \
            or not torch.equal(got, want):
        raise AssertionError("K4 with tables in global memory disagrees "
                             "with its plain version")
    phase("K4_own_tables", images=len(bufs), equal=True, ok=True,
          passes=int(passes), unique_table_rows=ks[7], lanes=ks[1],
          build=build, ms=timed(lambda: hd.decode_scan_chunked(
              args, ks, comp_of), 5),
          note="ms: K4 + K5 with the tables read from global memory")


def k1_chain(hd, args, ks, comp_of, timed):
    """K1's chain at this batch: each lane's symbols (the plain step in
    lockstep on the card), the longest lane alone (its arrays, its blocks
    at the start of a one-image output) timed by its kernel's device
    time, and ns a symbol on it."""
    import torch

    t = hd._plain_tables(args, comp_of)
    lanes = torch.arange(ks[1], device=args.words.device)
    pos = args.lane_word_base.to(torch.int64) * 32
    end = pos + args.lane_bits.to(torch.int64)
    slot, z, cnt = (torch.zeros_like(pos) for _ in range(3))
    for _ in range(ks[2]):
        active = pos < end
        if not bool(active.any()):
            break
        pos, slot, z, *_ = hd._symbol(t, lanes, pos, slot, z, active, ks[3])
        cnt += active.to(torch.int64)
    lane = int(cnt.argmax())
    sl = slice(lane, lane + 1)
    b0 = args.lane_blk_base[sl]
    nblk = int(args.lane_blk_limit[lane] - args.lane_blk_base[lane])
    one = hd.DecoderArgs(
        args.words, args.lane_word_base[sl].contiguous(),
        args.lane_bits[sl].contiguous(), args.lane_pinned[sl].contiguous(),
        torch.zeros_like(b0), (args.lane_blk_base[sl] - b0).contiguous(),
        (args.lane_blk_limit[sl] - b0).contiguous(), args.limit, args.delta,
        args.hv, args.lane_uid6[sl].contiguous(), args.ri_blk[:1])
    ks1 = list(ks)
    ks1[1], ks1[5], ks1[6] = 1, -(-nblk // ks[3]), 1
    ks1 = tuple(ks1)
    kernels = device_ms_by_kernel(lambda: hd.decode_scan(one, ks1, comp_of),
                                  20)
    decode = [v["ms"] for k, v in kernels.items()
              if isinstance(v, dict) and "decode" in k] \
        if isinstance(kernels, dict) else []
    symbols = int(cnt.max())
    return dict(longest_lane_symbols=symbols,
                mean_lane_symbols=float(cnt[args.lane_bits > 0]
                                        .float().mean()),
                longest_lane_ms=timed(lambda: hd.decode_scan(one, ks1,
                                                             comp_of), 20),
                longest_lane_kernels=kernels,
                ns_a_symbol=(decode[0] * 1e6 / symbols if decode
                             else "not measured"),
                call_kernels=device_ms_by_kernel(
                    lambda: hd.decode_scan(args, ks, comp_of)))


def k1_own_tables(dev, timed, srcs):
    """K1 at shape (c): 16 of the sources re-encoded by Pillow with
    optimize=True and restart markers every 8 MCUs at qualities 80-95
    (each image its own Huffman tables), against the plain version."""
    import torch
    from PIL import Image

    from picha_tpu_torch.ops import jpeg_huffman_decode as hd
    from picha_tpu_torch.ops.jpeg_scan import mcu_slot_tables, parse_baseline

    bufs = []
    for i in range(N_IMG):
        b = io.BytesIO()
        Image.open(io.BytesIO(srcs[i % 3])).save(
            b, "JPEG", quality=80 + i, optimize=True, restart_marker_blocks=8)
        bufs.append(b.getvalue())
    infos = [parse_baseline(b) for b in bufs]
    ks, wire = hd.scan_wire(infos)
    comp_of = torch.as_tensor(mcu_slot_tables(infos[0].comp_sig)).to(
        dev, torch.int32)
    args, _q = hd.wire_unpack(torch.from_numpy(wire).to(dev), ks,
                              infos[0].ncomp)
    if not ks[9]:
        raise AssertionError("shape (c) is not a restart single-pass batch")
    got, ok = hd.decode_scan(args, ks, comp_of)
    want, ok_p = hd.decode_scan_plain(args, ks, comp_of)
    torch.cuda.synchronize()
    if not (bool(ok) and bool(ok_p)) or not torch.equal(got, want):
        raise AssertionError("K1 at shape (c) disagrees with its plain "
                             "version")
    return dict(images=len(bufs), unique_table_rows=ks[7], equal=True,
                ms=timed(lambda: hd.decode_scan(args, ks, comp_of), 5),
                **k1_chain(hd, args, ks, comp_of, timed),
                build=hd.restart_kernel_info(ks[7], ks[1]))


def mean_abs(a_bufs, b_bufs):
    return [float(abs(decode_rgb(a) - decode_rgb(b)).mean())
            for a, b in zip(a_bufs, b_bufs)]


def timed(fn, reps, warm=1):
    """CUDA-event ms per call of fn (enqueue + device work)."""
    from picha_tpu_torch.runtime import CudaTimer

    for _ in range(warm):
        fn()
    with CudaTimer() as t:
        for _ in range(reps):
            fn()
    return t.ms / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    from picha_tpu_torch.kernels import (KERNELS, _build, launch_counts,
                                         reset_launch_counts)
    from picha_tpu_torch.ops import jpeg as jpeg_mod
    from picha_tpu_torch.ops import jpeg_huffman_decode as hd_mod
    from picha_tpu_torch.ops.scan_batch import MAX_PASSES
    from picha_tpu_torch.ops.jpeg import (
        dequant_idct_plane, dequant_idct_plane_plain, encode_blocks,
        encode_blocks_plain, front_samples, full_fp32, idct_samples,
        k7_build, plane_geometry, upsample_color, upsample_color_plain)
    from picha_tpu_torch.ops.jpeg_fused import fused_decode_resize
    from picha_tpu_torch.ops.jpeg_huffman import (kernel_info as k3_info,
                                                  scan_encode,
                                                  scan_encode_plain)
    from picha_tpu_torch.ops.jpeg_huffman_decode import (
        dc_integrate, dc_integrate_plain, decode_scan, decode_scan_chunked,
        decode_scan_chunked_plain, decode_scan_plain, scan_wire,
        split_planes, wire_unpack)
    from picha_tpu_torch.ops import resize as resize_mod
    from picha_tpu_torch.ops.resize import (INV255, resize_axis,
                                            resize_axis_windowed_plain,
                                            resize_f32_plain,
                                            resize_windowed, windowed_plan)
    from picha_tpu_torch.ops.resize_weights import resize_weights
    from picha_tpu_torch.pipeline import JpegBatchPipeline
    from picha_tpu_torch.pipeline.jpeg_batch import device_graph, signature
    from picha_tpu_torch.runtime import card_id

    # 1. card and build ---------------------------------------------------
    card = card_id()
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0,
          library=str(_build.library_path().relative_to(ROOT)))

    srcs = [(FIXTURES / f"src_{i}.jpg").read_bytes() for i in range(3)]
    srcs_nr = [(FIXTURES / f"src_nr_{i}.jpg").read_bytes() for i in range(3)]
    refs = [(FIXTURES / f"ref_{i}.jpg").read_bytes() for i in range(3)]
    corpus = [srcs[i % 3] for i in range(N_IMG)]
    corpus_nr = [srcs_nr[i % 3] for i in range(N_IMG)]
    strict = [refs[i % 3] for i in range(N_IMG)]
    mpix = N_IMG * SRC_W * SRC_H / 1e6

    pipe = JpegBatchPipeline(width=OUT_W, height=OUT_H,
                             encode_quality=QUALITY, encode_backend="device",
                             fused=True, upload="scan", device=dev)
    pipe_s = JpegBatchPipeline(width=OUT_W, height=OUT_H,
                               encode_quality=QUALITY,
                               encode_backend="device", fused=False,
                               upload="scan", device=dev)

    def staged_plain(sig, planes, qt, consts):
        """The staged pixel stages through K6-K8's plain versions."""
        geom = plane_geometry(sig[3], sig[0], sig[1])
        ys = [dequant_idct_plane_plain(p, q, consts.kron, dh, dw)
              for p, q, (dh, dw, _fx, _fy) in zip(planes, qt, geom)]
        rgb = upsample_color_plain(ys, sig[3], sig[2], sig[0], sig[1])
        (sw, tw), (sh, th) = consts.windows
        return resize_axis_windowed_plain(
            resize_axis_windowed_plain(rgb, sw, tw, -2), sh, th, -3, 255.0)

    def plain_graph(buf, ks, sig, consts, cap):
        """device_graph's stages with each kernel's plain torch version
        in its place, on the same device (staged when the constants
        carry resize windows, else fused)."""
        dargs, qt = wire_unpack(buf, ks, len(sig[3]))
        if ks[9]:
            coefs, ok = decode_scan_plain(dargs, ks, consts.comp_of)
        else:
            coefs, ok, _passes = decode_scan_chunked_plain(dargs, ks,
                                                           consts.comp_of)
        planes = split_planes(coefs, sig[3], consts.split_idx)
        if consts.windows is not None:
            f255 = staged_plain(sig, planes, qt, consts)
        else:
            f255 = fused_decode_resize(sig[3], sig[2], planes, qt,
                                       consts.weights)
        blocks = encode_blocks_plain(f255, consts.qluma, consts.qchroma,
                                     consts.kron)
        return scan_encode_plain(blocks, consts.layout, consts.tab, cap), ok

    # 2. kernels vs plain at the main path's shapes ------------------------
    infos = pipe.entropy_decode(corpus)
    ks, wire = scan_wire(infos)    # raises unless restart single-pass
    sig = signature(infos[0])
    consts = pipe.constants(sig)
    cap = pipe._scan_cap_for(sig)
    wire_dev = torch.from_numpy(wire).pin_memory().to(dev)
    dargs, qtabs = wire_unpack(wire_dev, ks, len(sig[3]))
    results = {}

    before = launch_counts()
    coefs_k, ok_k = decode_scan(dargs, ks, consts.comp_of)
    coefs_p, ok_p = decode_scan_plain(dargs, ks, consts.comp_of)
    torch.cuda.synchronize()
    if not (bool(ok_k) and bool(ok_p)) or not torch.equal(coefs_k, coefs_p):
        raise AssertionError("K1 disagrees with its plain version")
    err = int((coefs_k - coefs_p).abs().max())
    results["huffman_decode_restart"] = dict(
        max_abs_err=err,
        ms=timed(lambda: decode_scan(dargs, ks, consts.comp_of), 5),
        plain_ms=timed(lambda: decode_scan_plain(dargs, ks, consts.comp_of),
                       1),
        **k1_chain(hd_mod, dargs, ks, consts.comp_of, timed),
        build=hd_mod.restart_kernel_info(ks[7], ks[1]),
        own_tables=k1_own_tables(dev, timed, srcs))
    phase("K1", equal=True, ok=True, shape=list(coefs_k.shape),
          note="ms: the call (table build + decode); longest_lane_*: the "
               "lane with the most symbols alone, one launch of one lane "
               "(the chain's floor), ns_a_symbol its kernel's device time "
               "over its symbols; own_tables: shape (c), each image its own "
               "Huffman tables (K1 reads them from global memory), equal "
               "to the plain version", **results["huffman_decode_restart"])

    planes = split_planes(coefs_k, sig[3], consts.split_idx)
    f255 = fused_decode_resize(sig[3], sig[2], planes, qtabs,
                               consts.weights)
    front = (f255, consts.qluma, consts.qchroma, consts.kron)
    blocks_k = encode_blocks(*front)
    blocks_p = encode_blocks_plain(*front)
    k2_off, n_all, err = 0, 0, 0
    for g, w in zip(blocks_k, blocks_p):
        d = (g.to(torch.int32) - w.to(torch.int32)).abs()
        err = max(err, int(d.max()))
        k2_off += int((d > 0).sum())
        n_all += d.numel()
    if err > 1 or k2_off > K2_MAX_OFF_BY_ONE * n_all:
        raise AssertionError(f"K2: max |diff| {err}, {k2_off}/{n_all} off")
    results["jpeg_encode_front"] = dict(
        max_abs_err=err, ms=timed(lambda: encode_blocks(*front), 10),
        plain_ms=timed(lambda: encode_blocks_plain(*front), 3))
    phase("K2", off_by_one=k2_off, coefficients=n_all,
          limit=K2_MAX_OFF_BY_ONE, build=jpeg_mod.encode_kernel_info(f255),
          **results["jpeg_encode_front"])

    scan_k, nb_k = scan_encode(blocks_k, consts.layout, consts.tab, cap)
    scan_p, nb_p = scan_encode_plain(blocks_k, consts.layout, consts.tab, cap)
    if not (torch.equal(nb_k, nb_p) and torch.equal(scan_k, scan_p)):
        raise AssertionError("K3 disagrees with its plain version")
    if int(nb_k.max()) > cap:
        raise AssertionError(f"K3 overflow at the default cap {cap}")
    err = max(int((scan_k.int() - scan_p.int()).abs().max()),
              int((nb_k - nb_p).abs().max()))
    results["huffman_encode_scan"] = dict(
        max_abs_err=err,
        ms=timed(lambda: scan_encode(blocks_k, consts.layout, consts.tab,
                                     cap), 10),
        plain_ms=timed(lambda: scan_encode_plain(
            blocks_k, consts.layout, consts.tab, cap), 3))
    phase("K3", identical=True, nbytes_max=int(nb_k.max()), byte_cap=cap,
          kernels=device_ms_by_kernel(lambda: scan_encode(
              blocks_k, consts.layout, consts.tab, cap)),
          build=k3_info(blocks_k, consts.layout, cap),
          note="ms: the call (CUDA events); kernels: its device time by "
               "kernel (torch.profiler)", **results["huffman_encode_scan"])

    # K4 + K5: the same pixels without restart markers (chunked mode)
    infos_nr = pipe.entropy_decode(corpus_nr)
    ks_nr, wire_nr = scan_wire(infos_nr)
    if ks_nr[9] or signature(infos_nr[0]) != sig:
        raise AssertionError(f"no-restart corpus not chunked: {ks_nr}")
    wire_nr_dev = torch.from_numpy(wire_nr).pin_memory().to(dev)
    dargs_nr, _qt = wire_unpack(wire_nr_dev, ks_nr, len(sig[3]))

    def k4():
        return decode_scan_chunked(dargs_nr, ks_nr, consts.comp_of)

    def k4_plain():
        return decode_scan_chunked_plain(dargs_nr, ks_nr, consts.comp_of)

    coefs4, ok4, passes4 = k4()
    coefs4_p, ok4_p, passes4_p = k4_plain()
    torch.cuda.synchronize()
    if not (bool(ok4) and bool(ok4_p)) or int(passes4) != int(passes4_p):
        raise AssertionError(f"K4 ok {bool(ok4)} / plain {bool(ok4_p)}, "
                             f"passes {int(passes4)} / {int(passes4_p)}")
    if not torch.equal(coefs4, coefs4_p):
        raise AssertionError("K4 disagrees with its plain version")
    if not torch.equal(coefs4, coefs_k):
        raise AssertionError("K4 on the no-restart corpus disagrees with K1 "
                             "on the restart corpus")
    results["huffman_decode_chunked"] = dict(
        max_abs_err=int((coefs4 - coefs4_p).abs().max()),
        ms=timed(k4, 5), plain_ms=timed(k4_plain, 1, warm=0))
    phase("K4", equal=True, ok=True, equal_to_K1=True, passes=int(passes4),
          chunk_bits=ks_nr[0], lanes=ks_nr[1], steps=ks_nr[2],
          windows=hd_mod.K4_WINDOWS,
          build=hd_mod.kernel_info(n_uniq=ks_nr[7], n_lanes=ks_nr[1]),
          k4_alone_ms=timed(lambda: hd_mod._decode_scan_chunked_kernel(
              dargs_nr, ks_nr, consts.comp_of, MAX_PASSES), 5),
          note="ms: K4 + K5, plain_ms: decode_scan_chunked_plain",
          **results["huffman_decode_chunked"])
    k4_own_tables(dev, phase, timed, srcs_nr)

    # K5 alone: K4's output read as DC diffs
    ri_blk = dargs_nr.ri_blk
    x5 = coefs4.clone()
    got5 = dc_integrate(x5.clone(), consts.comp_of, ri_blk, infos_nr[0].mcus)
    want5 = dc_integrate_plain(x5.clone(), consts.comp_of, ri_blk,
                               infos_nr[0].mcus)
    if not torch.equal(got5, want5):
        raise AssertionError("K5 disagrees with dc_integrate_plain")
    results["dc_integrate"] = dict(
        max_abs_err=int((got5 - want5).abs().max()),
        ms=timed(lambda: dc_integrate(x5, consts.comp_of, ri_blk,
                                      infos_nr[0].mcus), 10),
        plain_ms=timed(lambda: dc_integrate_plain(
            x5, consts.comp_of, ri_blk, infos_nr[0].mcus), 3))
    phase("K5", equal=True, shape=list(x5.shape), **results["dc_integrate"])

    # K6-K8: the staged pixel stages on K1's coefficients
    consts_s = pipe_s.constants(sig)
    geom = plane_geometry(sig[3], SRC_W, SRC_H)

    def k6(plain=False):
        fn = dequant_idct_plane_plain if plain else dequant_idct_plane
        return [fn(p, q, consts_s.kron, dh, dw)
                for p, q, (dh, dw, _fx, _fy) in zip(planes, qtabs, geom)]

    ys_k, ys_p = k6(), k6(plain=True)
    k6_off, k6_ties, n6, err = 0, 0, 0, 0
    for p, q, g, w, (dh, dw, _fx, _fy) in zip(planes, qtabs, ys_k, ys_p,
                                              geom):
        d = (g.to(torch.int32) - w.to(torch.int32)).abs()
        pre = idct_samples(p, q, consts_s.kron)[:, :dh, :dw]
        near = (pre - pre.floor() - 0.5).abs() < K6_NEAR_TIE
        err = max(err, int(d.max()))
        k6_off += int((d > 0).sum())
        k6_ties += int(near.sum())
        n6 += d.numel()
        if bool(((d > 0) & ~near).any()):
            raise AssertionError("K6 differs from its plain version away "
                                 "from a .5 tie")
    if err > 1:
        raise AssertionError(f"K6: max |diff| {err}")
    planes16 = [pl.to(torch.int16) for pl in planes]
    ys16 = [dequant_idct_plane(p, q, consts_s.kron, dh, dw)
            for p, q, (dh, dw, _fx, _fy) in zip(planes16, qtabs, geom)]
    if not all(torch.equal(a, b) for a, b in zip(ys16, ys_k)):
        raise AssertionError("K6 on int16 coefficients differs from int32")
    results["idct_plane"] = dict(
        max_abs_err=err, ms=timed(k6, 10),
        plain_ms=timed(lambda: k6(plain=True), 3))
    phase("K6", off_by_one=k6_off, near_ties=k6_ties, samples=n6,
          near_tie_limit=K6_NEAR_TIE, planes=[list(y.shape) for y in ys_k],
          int16_equal=True, ms_int16=timed(lambda: [
              dequant_idct_plane(p, q, consts_s.kron, dh, dw)
              for p, q, (dh, dw, _fx, _fy) in zip(planes16, qtabs, geom)], 10),
          build=jpeg_mod.kernel_info(), **results["idct_plane"])
    del planes16, ys16

    color = (sig[3], sig[2], SRC_W, SRC_H)
    rgb_k = upsample_color(ys_k, *color)
    rgb_p = upsample_color_plain(ys_k, *color)
    if not torch.equal(rgb_k, rgb_p):
        raise AssertionError("K7 disagrees with its plain version")
    k7_builds = {k[3:]: v for k, v in jpeg_mod.kernel_info().items()
                 if k.startswith("K7_")}
    results["upsample_color"] = dict(
        max_abs_err=int((rgb_k.int() - rgb_p.int()).abs().max()),
        ms=timed(lambda: upsample_color(ys_k, *color), 10),
        plain_ms=timed(lambda: upsample_color_plain(ys_k, *color), 3),
        build=k7_builds[k7_build(*color)],
        buckets=k7_signature_buckets(dev, timed, k7_builds))
    phase("K7", equal=True, shape=list(rgb_k.shape),
          build_name=k7_build(*color),
          bound=bound(sum(y.numel() for y in ys_k) + rgb_k.numel()),
          note="buckets: K7's other compiled-in signatures on 16 seeded "
               "random 1920x1088 planes, each equal to its plain version; "
               "the ingest's 256 x 1920x1088 4:2:0 bucket is "
               "timing_training's K7 stage (appended there; held against "
               "the plain version once, 64 images at a time); build: the "
               "launched build's registers, spill bytes, static shared "
               "bytes, blocks an SM and threads",
          **results["upsample_color"])

    (sw, tw), (sh, th) = consts_s.windows
    xw_k = resize_axis(rgb_k, sw, tw, -2)
    xw_p = resize_axis_windowed_plain(rgb_k, sw, tw, -2)
    xh_k = resize_axis(xw_k, sh, th, -3, 255.0)
    xh_p = resize_axis_windowed_plain(xw_k, sh, th, -3, 255.0)
    if not (torch.equal(xw_k, xw_p) and torch.equal(xh_k, xh_p)):
        raise AssertionError("K8 disagrees with its windowed plain version")
    # the one-launch resize (resize_2d), the staged path's: both axes
    # equal to the two windowed twins
    plan8 = windowed_plan(rgb_k, consts_s.windows)
    if plan8["route"] != "one_launch":
        raise AssertionError(f"K8 at the transcode's shape: {plan8}")
    x2_k = resize_windowed(rgb_k, consts_s.windows, 255.0)
    if not torch.equal(x2_k, xh_p):
        raise AssertionError("K8's one-launch resize differs from the two "
                             "windowed twins")
    x01 = rgb_k.to(torch.float32) * INV255
    banded = resize_f32_plain(x01, OUT_W, OUT_H, pipe_s._filter,
                              pipe_s._fscale)
    vs_banded = float((resize_axis(xw_k, sh, th, -3) - banded).abs().max())
    if vs_banded > RESIZE_TOL:
        raise AssertionError(f"K8 vs the banded plan: {vs_banded}")
    k8 = dict(
        width_ms=timed(lambda: resize_axis(rgb_k, sw, tw, -2), 10),
        width_plain_ms=timed(
            lambda: resize_axis_windowed_plain(rgb_k, sw, tw, -2), 3),
        height_ms=timed(lambda: resize_axis(xw_k, sh, th, -3, 255.0), 10),
        height_plain_ms=timed(lambda: resize_axis_windowed_plain(
            xw_k, sh, th, -3, 255.0), 3),
        banded_plain_ms=timed(lambda: resize_f32_plain(
            x01, OUT_W, OUT_H, pipe_s._filter, pipe_s._fscale), 3))
    results["resize_axis"] = dict(
        max_abs_err=max(float((xw_k - xw_p).abs().max()),
                        float((xh_k - xh_p).abs().max())),
        ms=k8["width_ms"] + k8["height_ms"],
        plain_ms=k8["width_plain_ms"] + k8["height_plain_ms"])
    k8_builds = resize_mod.kernel_info(rgb_k, consts_s.windows)
    results["resize_2d"] = dict(
        max_abs_err=float((x2_k - xh_p).abs().max()),
        ms=timed(lambda: resize_windowed(rgb_k, consts_s.windows, 255.0), 10),
        plain_ms=results["resize_axis"]["plain_ms"], build=k8_builds)
    phase("K8", equal_to_windowed=True, max_abs_vs_banded=vs_banded,
          banded_limit=RESIZE_TOL, taps=[tw.shape[1], th.shape[1]],
          width_out=list(xw_k.shape), height_out=list(xh_k.shape),
          note="per-axis kernels (resize_rows, resize_cols): ms = width + "
               "height pass, plain_ms = their windowed twins; one_launch: "
               "resize_2d, the staged path's resize, equal to the two "
               "twins, route and tile from ops.resize.resize_plan, build "
               "from ops.resize.kernel_info",
          one_launch=dict(route=plan8["route"], equal_to_twins=True,
                          ms=results["resize_2d"]["ms"], plan=plan8,
                          builds=k8_builds),
          **k8, **results["resize_axis"])
    # bounds (this run's shapes) and the one-call PyTorch yardsticks: the
    # (..., 64) @ kron product for K2's fDCT and K6's IDCT, dense
    # torch.matmul resizes for K8; the other kernels have none
    blk_elems = sum(b.numel() for b in blocks_k)
    results["huffman_decode_restart"].update(
        bound(wire.nbytes + coefs_k.numel() * 4), library_ms=None)
    samples = torch.cat([smp.reshape(-1, 64) for smp in front_samples(f255)])
    samples = samples.to(torch.float32) - 128.0
    kron_t = consts.kron.t().contiguous()
    with full_fp32():
        k2_lib = timed(lambda: torch.matmul(samples, kron_t), 10)
    results["jpeg_encode_front"].update(
        bound(f255.numel() * 4 + blk_elems * 2, blk_elems * 128),
        library_ms=k2_lib)
    results["huffman_encode_scan"].update(
        bound(blk_elems * 2 + int(nb_k.sum()) + nb_k.numel() * 4),
        library_ms=None)
    results["huffman_decode_chunked"].update(
        bound(wire_nr.nbytes + coefs4.numel() * 4), library_ms=None)
    results["dc_integrate"].update(
        bound(x5.shape[0] * x5.shape[1] * 4 * 2), library_ms=None)
    deq = torch.cat([(pl.to(torch.float32) * q.to(torch.float32)).reshape(
        -1, 64) for pl, q in zip(planes, qtabs)])
    with full_fp32():
        k6_lib = timed(lambda: torch.matmul(deq, consts_s.kron), 10)
    coef_elems = sum(pl.numel() for pl in planes)
    nonzero = int((deq != 0).sum())
    # K6 skips zero coefficients: the work is the nonzero
    # coefficients' 64 products each (the dense bound beside it)
    results["idct_plane"].update(
        bound(coef_elems * 4 + sum(y.numel() for y in ys_k), nonzero * 128),
        library_ms=k6_lib, nonzero=nonzero, dense_bound_ms=bound(
            coef_elems * 4 + sum(y.numel() for y in ys_k),
            coef_elems * 128)["bound_ms"])
    results["upsample_color"].update(
        bound(sum(y.numel() for y in ys_k) + rgb_k.numel()), library_ms=None)
    w_dense = torch.as_tensor(resize_weights(OUT_W, SRC_W, pipe_s._filter,
                                             pipe_s._fscale), device=dev)
    h_dense = torch.as_tensor(resize_weights(OUT_H, SRC_H, pipe_s._filter,
                                             pipe_s._fscale), device=dev)
    x01_rows = x01.view(N_IMG * SRC_H, SRC_W, 3)
    xw_cols = xw_k.view(N_IMG, SRC_H, OUT_W * 3)
    with full_fp32():
        k8_lib = (timed(lambda: torch.matmul(w_dense, x01_rows), 5)
                  + timed(lambda: torch.matmul(h_dense, xw_cols), 5))
    results["resize_axis"].update(
        bound(rgb_k.numel() + xw_k.numel() * 8 + xh_k.numel() * 4,
              2 * (tw.shape[1] * xw_k.numel() + th.shape[1] * xh_k.numel())),
        library_ms=k8_lib)
    # the one launch moves the input once and the output once
    results["resize_2d"].update(
        bound(rgb_k.numel() + xh_k.numel() * 4,
              2 * (tw.shape[1] * xw_k.numel() + th.shape[1] * xh_k.numel())),
        library_ms=k8_lib)
    phase("bounds", card=card, note="bound_ms: max(bytes / 3.35 TB/s, "
          "FP32 FLOPs / 67 TFLOP/s); library_ms: one PyTorch call for the "
          "same function (K2, K6: the (..., 64) @ kron product; K8: dense "
          "torch.matmul, width + height)",
          k6_nonzero=results["idct_plane"]["nonzero"],
          k6_dense_bound_ms=results["idct_plane"]["dense_bound_ms"],
          **{k: {f: r[f] for f in ("bound_ms", "bound_by", "bound_bytes",
                                   "bound_flops", "library_ms")}
             for k, r in results.items()})
    # the two ported graphs that stay plain torch: the fused decode+resize
    # products (two contractions per component) and the split
    fused_flops = sum(
        2 * pl.shape[0] * pl.shape[1] * 8 * th_.shape[0] * pl.shape[2] * 8
        + 2 * pl.shape[0] * tv_.shape[0] * th_.shape[0] * pl.shape[1] * 8
        for pl, (th_, tv_) in zip(planes, consts.weights))
    phase("plain_graphs", card=card,
          fused_matmuls=dict(
              launches=2 * len(planes),
              ms=timed(lambda: fused_decode_resize(sig[3], sig[2], planes,
                                                   qtabs, consts.weights), 5),
              **bound(coef_elems * 4 + f255.numel() * 4, fused_flops)),
          split=dict(
              launches=len(planes),
              ms=timed(lambda: split_planes(coefs_k, sig[3],
                                            consts.split_idx), 10),
              **bound(coefs_k.numel() * 4 * 2)))
    del ys_p, rgb_p, xw_p, xh_p, x01, banded, samples, deq, x01_rows, xw_cols
    del x2_k
    after = launch_counts()
    if any(after[k] <= before[k] for k in results):
        raise AssertionError(f"launch counts did not move: {after}")

    # 3. the slice end to end ----------------------------------------------
    def plain_path(bufs, p=pipe):
        infos = p.entropy_decode(bufs)
        ks, wire = scan_wire(infos)
        sig = signature(infos[0])
        buf = torch.from_numpy(wire).pin_memory().to(dev, non_blocking=True)
        out, ok = plain_graph(buf, ks, sig, p.constants(sig),
                              p._scan_cap_for(sig))
        if not bool(ok):
            raise AssertionError("plain decoder flagged the corpus")
        return p.scan_finish(out, sig)

    def fallbacks(p=pipe):
        return {k: getattr(p, k) for k in (
            "scan_fallbacks", "overflow_retries", "overflow_fallbacks")}

    def check_slice(jpegs, label, p=pipe):
        if len(jpegs) != N_IMG:
            raise AssertionError(f"{label}: {len(jpegs)} outputs")
        lsb = mean_abs(jpegs, strict)
        if max(lsb) > PARITY_LSB:
            raise AssertionError(f"{label}: {max(lsb)} LSB from strict")
        if any(fallbacks(p).values()):
            raise AssertionError(f"{label}: fallbacks {fallbacks(p)}")
        return lsb

    restart_path = ("huffman_decode_restart", "jpeg_encode_front",
                    "huffman_encode_scan")
    chunked_path = ("huffman_decode_chunked", "dc_integrate",
                    "jpeg_encode_front", "huffman_encode_scan")
    reset_launch_counts()
    jpegs = pipe(corpus)
    torch.cuda.synchronize()
    main_launches = launch_counts()
    if any(main_launches[k] == 0 for k in restart_path):
        raise AssertionError(f"main path skipped a kernel: {main_launches}")
    lsb = check_slice(jpegs, "slice")
    plain_jpegs = plain_path(corpus)
    identical = sum(bytes(a) == bytes(b) for a, b in zip(jpegs, plain_jpegs))
    # K1 and K3 are exact and the fused stage is shared, so only a K2
    # off-by-one at an exact .5 tie (counted in phase 2 on these very
    # inputs) may make an output differ from the plain path's
    if identical != N_IMG and k2_off == 0:
        raise AssertionError(f"kernel path differs from the plain path on "
                             f"{N_IMG - identical} images")
    phase("slice", images=N_IMG, lsb_vs_strict_mean=sum(lsb) / N_IMG,
          lsb_vs_strict_max=max(lsb), limit_lsb=PARITY_LSB,
          identical_to_plain=identical, launches=main_launches,
          fallbacks=fallbacks(), bytes=[len(j) for j in jpegs])

    reset_launch_counts()
    jpegs_nr = pipe(corpus_nr)
    torch.cuda.synchronize()
    nr_launches = launch_counts()
    if (any(nr_launches[k] == 0 for k in chunked_path)
            or nr_launches["huffman_decode_restart"]):
        raise AssertionError(f"no-restart path launches: {nr_launches}")
    lsb_nr = check_slice(jpegs_nr, "slice_no_restart")
    same_nr = sum(bytes(a) == bytes(b) for a, b in zip(jpegs_nr, jpegs))
    if same_nr != N_IMG:
        raise AssertionError(f"no-restart outputs differ from the restart "
                             f"slice's on {N_IMG - same_nr} images")
    phase("slice_no_restart", images=N_IMG,
          lsb_vs_strict_mean=sum(lsb_nr) / N_IMG,
          lsb_vs_strict_max=max(lsb_nr), limit_lsb=PARITY_LSB,
          identical_to_restart_slice=same_nr, launches=nr_launches,
          fallbacks=fallbacks())

    # the staged slice (fused=False) on both corpora
    staged_path = ("idct_plane", "upsample_color", "resize_2d",
                   "jpeg_encode_front", "huffman_encode_scan")
    reset_launch_counts()
    jpegs_s = pipe_s(corpus)
    torch.cuda.synchronize()
    s_launches = launch_counts()
    if any(s_launches[k] == 0
           for k in ("huffman_decode_restart",) + staged_path):
        raise AssertionError(f"staged path skipped a kernel: {s_launches}")
    lsb_s = check_slice(jpegs_s, "slice_staged", pipe_s)
    vs_fused = mean_abs(jpegs_s, jpegs)
    plain_s = plain_path(corpus, pipe_s)
    identical_s = sum(bytes(a) == bytes(b) for a, b in zip(jpegs_s, plain_s))
    # K1, K7, K8 and K3 are exact: only a K6 or K2 off-by-one at a .5
    # tie (counted in phase 2 on these very inputs) may change an output
    if identical_s != N_IMG and k6_off == 0 and k2_off == 0:
        raise AssertionError(f"staged kernel path differs from its plain "
                             f"path on {N_IMG - identical_s} images")
    phase("slice_staged", images=N_IMG, lsb_vs_strict_mean=sum(lsb_s) / N_IMG,
          lsb_vs_strict_max=max(lsb_s), limit_lsb=PARITY_LSB,
          lsb_vs_fused_mean=sum(vs_fused) / N_IMG,
          lsb_vs_fused_max=max(vs_fused), identical_to_plain=identical_s,
          launches=s_launches, fallbacks=fallbacks(pipe_s),
          bytes=[len(j) for j in jpegs_s])

    reset_launch_counts()
    jpegs_s_nr = pipe_s(corpus_nr)
    torch.cuda.synchronize()
    s_nr_launches = launch_counts()
    if (any(s_nr_launches[k] == 0 for k in chunked_path[:2] + staged_path)
            or s_nr_launches["huffman_decode_restart"]):
        raise AssertionError(f"staged no-restart launches: {s_nr_launches}")
    lsb_s_nr = check_slice(jpegs_s_nr, "slice_staged_no_restart", pipe_s)
    same_s_nr = sum(bytes(a) == bytes(b)
                    for a, b in zip(jpegs_s_nr, jpegs_s))
    if same_s_nr != N_IMG:
        raise AssertionError(f"staged no-restart outputs differ from the "
                             f"restart ones on {N_IMG - same_s_nr} images")
    phase("slice_staged_no_restart", images=N_IMG,
          lsb_vs_strict_mean=sum(lsb_s_nr) / N_IMG,
          lsb_vs_strict_max=max(lsb_s_nr), limit_lsb=PARITY_LSB,
          identical_to_restart_slice=same_s_nr, launches=s_nr_launches,
          fallbacks=fallbacks(pipe_s))

    # staged decode-only: full-size uint8 images against Pillow's decode
    pipe_d = JpegBatchPipeline(encode_quality=None, fused=False,
                               upload="scan", device=dev)
    reset_launch_counts()
    imgs = pipe_d(corpus)
    torch.cuda.synchronize()
    d_launches = launch_counts()
    if (any(d_launches[k] == 0 for k in ("huffman_decode_restart",
                                         "idct_plane", "upsample_color"))
            or any(d_launches[k] for k in staged_path[2:])):
        raise AssertionError(f"staged decode-only launches: {d_launches}")
    if tuple(imgs.shape) != (N_IMG, SRC_H, SRC_W, 3) or any(
            fallbacks(pipe_d).values()):
        raise AssertionError(f"decode-only: shape {tuple(imgs.shape)}, "
                             f"fallbacks {fallbacks(pipe_d)}")
    pil = [decode_source(s) for s in srcs]
    host_imgs = imgs.cpu().numpy().astype("int32")
    dec = [abs(host_imgs[i] - pil[i % 3]) for i in range(N_IMG)]
    dec_mean = [float(d.mean()) for d in dec]
    if max(dec_mean) > DECODE_LSB:
        raise AssertionError(f"decode-only: {max(dec_mean)} LSB from Pillow")
    phase("decode_only_staged", images=N_IMG, shape=list(imgs.shape),
          lsb_vs_pillow_mean=sum(dec_mean) / N_IMG,
          lsb_vs_pillow_max_mean=max(dec_mean),
          max_abs_vs_pillow=int(max(d.max() for d in dec)),
          limit_lsb=DECODE_LSB, launches=d_launches)
    del imgs, host_imgs, dec

    # 4. TF32 switched on globally ------------------------------------------
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        jpegs_tf32 = pipe(corpus)
    finally:
        torch.set_float32_matmul_precision(prev)
    lsb_tf32 = check_slice(jpegs_tf32, "tf32")
    same = sum(bytes(a) == bytes(b) for a, b in zip(jpegs, jpegs_tf32))
    if same != N_IMG:
        raise AssertionError(f"TF32 on globally changed {N_IMG - same} "
                             f"outputs")
    phase("tf32_global", identical=same, lsb_vs_strict_max=max(lsb_tf32))

    # 5. timing -------------------------------------------------------------
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

    e2e_ms = wall(lambda: pipe(corpus), 5)
    e2e_plain_ms = wall(lambda: plain_path(corpus), 2)
    one_ms = wall(lambda: pipe(corpus[:1]), 9)

    def device_loop(wire_buf, scan_ks, fused=True):
        out, _ok = device_graph(sig, wire_buf,
                                consts if fused else consts_s, scan_ks,
                                byte_cap=cap, fused=fused)
        return out

    dev_ms = timed(lambda: device_loop(wire_dev, ks)[1].cpu(), 10)
    dev_plain_ms = timed(
        lambda: plain_graph(wire_dev, ks, sig, consts, cap)[0][1].cpu(), 2)
    phase("timing", card=card, mpix_per_batch=mpix,
          e2e_ms_per_batch=e2e_ms, e2e_mpix_s=mpix / e2e_ms * 1e3,
          e2e_plain_ms_per_batch=e2e_plain_ms,
          e2e_plain_mpix_s=mpix / e2e_plain_ms * 1e3,
          p50_ms_one_1080p_image=one_ms,
          device_only_ms=dev_ms, device_only_mpix_s=mpix / dev_ms * 1e3,
          device_only_plain_ms=dev_plain_ms,
          device_only_plain_mpix_s=mpix / dev_plain_ms * 1e3)

    e2e_nr_ms = wall(lambda: pipe(corpus_nr), 5)
    one_nr_ms = wall(lambda: pipe(corpus_nr[:1]), 9)
    dev_nr_ms = timed(lambda: device_loop(wire_nr_dev, ks_nr)[1].cpu(), 10)
    phase("timing_no_restart", card=card, mpix_per_batch=mpix,
          e2e_ms_per_batch=e2e_nr_ms, e2e_mpix_s=mpix / e2e_nr_ms * 1e3,
          p50_ms_one_1080p_image=one_nr_ms,
          device_only_ms=dev_nr_ms,
          device_only_mpix_s=mpix / dev_nr_ms * 1e3)

    # the staged path, beside the fused numbers of this call
    for label, bufs, wbuf, wks, fused_ms in (
            ("timing_staged", corpus, wire_dev, ks, (e2e_ms, one_ms, dev_ms)),
            ("timing_staged_no_restart", corpus_nr, wire_nr_dev, ks_nr,
             (e2e_nr_ms, one_nr_ms, dev_nr_ms))):
        s_e2e = wall(lambda: pipe_s(bufs), 5)
        s_one = wall(lambda: pipe_s(bufs[:1]), 9)
        s_dev = timed(lambda: device_loop(wbuf, wks, fused=False)[1].cpu(),
                      10)
        phase(label, card=card, mpix_per_batch=mpix,
              e2e_ms_per_batch=s_e2e, e2e_mpix_s=mpix / s_e2e * 1e3,
              p50_ms_one_1080p_image=s_one, device_only_ms=s_dev,
              device_only_mpix_s=mpix / s_dev * 1e3,
              fused_e2e_ms_per_batch=fused_ms[0],
              fused_p50_ms_one_1080p_image=fused_ms[1],
              fused_device_only_ms=fused_ms[2])

    # where one batch's time goes: host stages by wall clock, device
    # stages by CUDA events between them (medians of 5 batches)
    def stages_once(bufs, decode_name, staged=False):
        host, t = {}, time.perf_counter()
        infos = pipe.entropy_decode(bufs)
        host["parse"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        ks1, wire1 = scan_wire(infos)
        host["wire"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        buf = torch.from_numpy(wire1).pin_memory().to(dev, non_blocking=True)
        torch.cuda.synchronize()
        host["upload"] = (time.perf_counter() - t) * 1e3
        pixel = (["K6_idct", "K7_upsample_color", "K8_resize"]
                 if staged else ["fused_matmuls"])
        names = [decode_name, "split", *pixel, "K2_front", "K3_scan"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(
            len(names) + 1)]
        ev[0].record()
        dargs1, qt1 = wire_unpack(buf, ks1, len(sig[3]))
        coefs1, ok1 = decode_scan(dargs1, ks1, consts.comp_of)
        ev[1].record()
        planes1 = split_planes(coefs1, sig[3], consts.split_idx)
        ev[2].record()
        if staged:
            ys1 = [dequant_idct_plane(p, q, consts_s.kron, dh, dw)
                   for p, q, (dh, dw, _fx, _fy) in zip(planes1, qt1, geom)]
            ev[3].record()
            rgb1 = upsample_color(ys1, *color)
            ev[4].record()
            f1 = resize_windowed(rgb1, consts_s.windows, 255.0)
        else:
            f1 = fused_decode_resize(sig[3], sig[2], planes1, qt1,
                                     consts.weights)
        ev[-3].record()
        blocks1 = encode_blocks(f1, consts.qluma, consts.qchroma, consts.kron)
        ev[-2].record()
        out1 = scan_encode(blocks1, consts.layout, consts.tab, cap)
        ev[-1].record()
        torch.cuda.synchronize()
        device = {n: ev[i].elapsed_time(ev[i + 1])
                  for i, n in enumerate(names)}
        t = time.perf_counter()
        if not bool(ok1) or len(pipe.scan_finish(out1, sig)) != N_IMG:
            raise AssertionError("stage run failed")
        host["readback_assemble"] = (time.perf_counter() - t) * 1e3
        return host, device

    for label, bufs, decode_name, staged in (
            ("stages", corpus, "K1_decode", False),
            ("stages_no_restart", corpus_nr, "K4_K5_decode", False),
            ("stages_staged", corpus, "K1_decode", True),
            ("stages_staged_no_restart", corpus_nr, "K4_K5_decode", True)):
        runs = [stages_once(bufs, decode_name, staged)
                for _ in range(6)][1:]
        host_ms = {k: sorted(r[0][k] for r in runs)[len(runs) // 2]
                   for k in runs[0][0]}
        device_ms = {k: sorted(r[1][k] for r in runs)[len(runs) // 2]
                     for k in runs[0][1]}
        phase(label, card=card, host_ms=host_ms, device_ms=device_ms,
              host_sum_ms=sum(host_ms.values()),
              device_sum_ms=sum(device_ms.values()))

    # 6. the training ingest ------------------------------------------------
    ingest_launches, ingest_device_ms = training_phases(
        dev, card, results, phase, timed, wall)

    # 8-10. the pixel-array path ---------------------------------------------
    pixel_launches = pixel_phases(dev, card, results, phase, timed, wall)

    # 11-12. the batched PNG and TIFF decode -----------------------------------
    decode_launches = decode_phases(dev, card, results, phase, timed, wall)

    # 13-14. the ViT that consumes the ingest's batches -----------------------
    vit_launches = vit_phases(dev, card, results, phase, timed, wall,
                              ingest_device_ms)

    # 15-16. the ViT train step: loss, backward, AdamW, checkpoint ---------
    train_launches = train_phases(dev, card, results, phase, timed, wall,
                                  ingest_device_ms)

    # 17-18. the ResNet forward and train step fed by the ingest ----------
    resnet_launches = resnet_phases(dev, card, results, phase, timed, wall,
                                    ingest_device_ms)

    # 19-21. the host-coefficient uploads (row 8a) on the slice's batch
    upload_launches = upload_phases(
        dev, card, results, phase, timed, wall,
        {"restart": corpus, "no_restart": corpus_nr},
        split_planes(coefs_k, sig[3], consts.split_idx),
        split_planes(coefs4, sig[3], consts.split_idx),
        {True: jpegs, False: jpegs_s})

    # 22-23. the model configurations past the tuned kernels' envelopes (F5)
    f5_phases(dev, card, results, phase, timed)

    # 24-28. the raw420 and "tpu" encode backends (row 8b) on the slice
    raw420_launches = raw420_phases(dev, card, results, phase, timed, wall,
                                    corpus, strict, {True: jpegs,
                                                     False: jpegs_s})

    # 29-30. ViTConfig(image_size=384) at full width: the tiled K18 / K22
    vit384_phases(dev, card, results, phase, timed)

    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "picha_tpu" or m.startswith("picha_tpu."))
    if bad:
        raise AssertionError(f"the port imported the reference: {bad}")
    # launches: each kernel's count in the run of the path it serves
    # (K1-K3: the restart slice; K4, K5: the no-restart slice; K6, K7
    # and K8's one launch: the staged restart slice; K9 and K10: an
    # ingest step; K9's width pass and K8's per-axis kernels: an ingest
    # step on K9's per-axis route (crop 1024 -> 64); K11: the
    # config-4 call; K12: the batched PNG encode; K13-K16: the full-size
    # PNG and TIFF decode calls; K17, K18: the dense ViT forward; K19,
    # K20: the MoE one; K21, K22: the dense train step; K23, K24: the MoE
    # one; K25, K26: the ResNet train step; K27-K30: the fused restart
    # slice of their upload; K31: the fused restart raw420 slice)
    path_launches = {**main_launches,
                     **{k: nr_launches[k] for k in chunked_path[:2]},
                     **{k: s_launches[k] for k in staged_path[:3]},
                     **{k: ingest_launches[k]
                        for k in ("crop_flip_resize", "crop_flip_resize_w",
                                  "augment", "resize_axis")},
                     **pixel_launches, **decode_launches, **vit_launches,
                     **train_launches, **resnet_launches, **upload_launches,
                     **raw420_launches}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # "buckets": a kernel also timed on another bucket of its path
    kernels = [dict(name=k.name, route="cuda", source=k.source,
                    replaces=k.replaces, launches=path_launches[k.name],
                    **{f: results[k.name][f] for f in keys
                       + ("buckets",) * ("buckets" in results[k.name])})
               for k in KERNELS.values()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


def training_phases(dev, card, results, phase, timed, wall):
    """Phases 6 and 7: the training ingest at 256 x 1080p -> 224 (see the
    module doc). Fills results for K9 and K10; returns the launch counts
    of the main ingest step and the device stages' ms of one step."""
    import numpy as np
    import torch
    from PIL import Image

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.ops.jpeg import (_idct_kron, dequant_idct_plane,
                                          plane_geometry, upsample_color,
                                          upsample_color_plain)
    from picha_tpu_torch.ops.jpeg_huffman_decode import (
        _decode_scan_chunked_kernel, dc_integrate, scan_wire, split_planes,
        wire_unpack)
    from picha_tpu_torch.ops.jpeg_scan import mcu_slot_tables
    from picha_tpu_torch.ops.resize import (
        crop_flip_resize, crop_flip_resize_plain, crop_flip_resize_w,
        crop_flip_resize_w_plain, crop_kernel_info, resize_axis,
        resize_axis_windowed_plain)
    from picha_tpu_torch.ops.resize_weights import resize_weights
    from picha_tpu_torch.ops.scan_batch import MAX_PASSES, split_indices
    from picha_tpu_torch.ops.jpeg import full_fp32
    from picha_tpu_torch.pipeline import TrainingInput
    from picha_tpu_torch.pipeline.augment import (augment_fused,
                                                  augment_fused_lanes,
                                                  augment_fused_plain,
                                                  draw_augment)
    from picha_tpu_torch.pipeline.augment import kernel_info as k10_info
    from picha_tpu_torch.pipeline.jpeg_batch import signature

    srcs_nr = [(FIXTURES / f"src_nr_{i}.jpg").read_bytes() for i in range(3)]
    corpus = [srcs_nr[i % 3] for i in range(TRAIN_N)]
    ingest_path = ("huffman_decode_chunked", "dc_integrate", "idct_plane",
                   "upsample_color", "crop_flip_resize", "augment")
    # K9's per-axis route (windows no tile holds): its width pass, then
    # K8's height pass
    per_axis = ("crop_flip_resize_w", "resize_axis")

    def make(augment=AUGMENT, **kw):
        kw = {"batch": TRAIN_N, "crop": CROP, "size": SIZE, "seed": 0,
              "augment": augment, "device": dev, **kw}
        return TrainingInput(kw.pop("items", corpus), **kw)

    def step_of(ti):
        """(epoch, pos, bufs) of the step `ti` has just taken."""
        st = ti.state()
        pos = st["pos"] - ti.batch
        return st["epoch"], pos, [ti.items[i] for i in
                                  ti._perm[pos:pos + ti.batch]]

    def check_out(out, label, n=TRAIN_N, size=SIZE):
        if (tuple(out.shape) != (n, size, size, 3)
                or out.dtype != torch.float32 or out.device != dev):
            raise AssertionError(f"{label}: {tuple(out.shape)} {out.dtype} "
                                 f"{out.device}")
        lo, hi = float(out.min()), float(out.max())
        if not (bool(torch.isfinite(out).all()) and lo >= 0.0 and hi <= 1.0):
            raise AssertionError(f"{label}: range [{lo}, {hi}]")
        return lo, hi

    def chains(ti, epoch, pos, bufs):
        """The step's decoded frames and draws, through the kernel chain
        and through the plain chain: (k9, k9_plain, out, out_plain,
        inputs); k9 is K9's output (both resize passes), checked here
        against the plain chain and against K9's per-axis route (its
        width pass, then K8's height pass), the width pass against its
        plain version."""
        groups, windows = ti.plan(epoch, pos, bufs)
        if len(groups) != 1:
            raise AssertionError(f"{len(groups)} signatures in the corpus")
        rgb, ok = ti.decode(groups[0][2])
        draws = groups[0][3]
        if windows is not None:
            xs = torch.as_tensor(windows[:, 0]).to(dev)
            ys = torch.as_tensor(windows[:, 1]).to(dev)
        else:
            xs, ys = draws.xs.to(dev), draws.ys.to(dev)
        flip = draws.flip.to(dev)
        aug = None if draws.aug is None else draws.aug.to(dev)
        (sw, tw), (sh, th) = ti._windows
        k9 = crop_flip_resize(rgb, xs, ys, flip, ti.crop, ti._windows)
        k9p = crop_flip_resize_plain(rgb, xs, ys, flip, ti.crop,
                                     ti._windows)
        width = crop_flip_resize_w(rgb, xs, ys, flip, ti.crop, sw, tw)
        if not torch.equal(width, crop_flip_resize_w_plain(
                rgb, xs, ys, flip, ti.crop, sw, tw)):
            raise AssertionError("K9's width pass differs from its plain "
                                 "version")
        if not (torch.equal(k9, k9p) and torch.equal(
                k9, resize_axis(width, sh, th, -3))):
            raise AssertionError("K9 differs from the plain chain or from "
                                 "its per-axis route")
        del width
        if aug is None:
            outk, outp = k9.clamp(0.0, 1.0), k9p.clamp(0.0, 1.0)
        else:
            outk = augment_fused(k9, aug, ti.augment)
            outp = augment_fused_plain(k9p, aug, ti.augment)
        torch.cuda.synchronize()
        if not bool(ok):
            raise AssertionError("the decoder flagged the ingest corpus")
        return k9, k9p, outk, outp, (rgb, xs, ys, flip, aug, windows, draws)

    # the main ingest run: three steps with augment
    ti = make()
    steps, main_launches, step_ms = [], None, []
    for k in range(3):
        saved = ti.state()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = ti.__next__()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        if k == 0:
            main_launches = counts
        if any(counts[name] == 0 for name in ingest_path) \
                or counts["huffman_decode_restart"] \
                or any(counts[name] for name in per_axis):
            raise AssertionError(f"ingest step {k} launches: {counts}")
        if ti.scan_fallbacks:
            raise AssertionError(f"ingest fallbacks: {ti.scan_fallbacks}")
        lo, hi = check_out(out, f"ingest step {k}")
        epoch, pos, bufs = step_of(ti)
        k9, k9p, outk, outp, inputs = chains(ti, epoch, pos, bufs)
        err10 = float((outk - outp).abs().max())
        if err10 > K10_TOL:
            raise AssertionError(f"step {k}: K10 {err10} from its twin")
        if not torch.equal(outk, out):
            raise AssertionError(f"step {k}: the step differs from its "
                                 f"chain rerun")
        resumed = None
        if k == 1:
            resumed = torch.equal(make(state=saved).__next__(), out)
            if not resumed:
                raise AssertionError("step resumed from state() differs")
        steps.append(dict(epoch=epoch, pos=pos, min=lo, max=hi,
                          mean=float(out.mean()), k9_equal_plain=True,
                          k10_max_abs_vs_plain=err10,
                          resume_bit_equal=resumed, launches=counts))
        if k == 0:
            first = (k9, k9p, outk, outp, inputs)
        del out, k9, k9p, outk, outp, inputs
    phase("training", card=card, images=TRAIN_N, crop=CROP, size=SIZE,
          augment=AUGMENT, steps=steps, step_ms=step_ms,
          scan_fallbacks=ti.scan_fallbacks)

    # K9 and K10 against their plain versions at the slice's shape
    k9, k9p, outk, outp, (rgb, xs, ys, flip, aug, _w, _d) = first
    windows = ti._windows
    (sw, tw), (sh, th) = windows
    crops = TRAIN_N * CROP * CROP * 3
    width = crop_flip_resize_w(rgb, xs, ys, flip, CROP, sw, tw)
    results["crop_flip_resize"] = dict(
        max_abs_err=float((k9 - k9p).abs().max()),
        ms=timed(lambda: crop_flip_resize(rgb, xs, ys, flip, CROP, windows),
                 10),
        plain_ms=timed(lambda: crop_flip_resize_plain(
            rgb, xs, ys, flip, CROP, windows), 3),
        library_ms=None,
        per_axis_ms=timed(lambda: resize_axis(crop_flip_resize_w(
            rgb, xs, ys, flip, CROP, sw, tw), sh, th, -3), 10),
        build=crop_kernel_info(rgb, CROP, windows),
        **bound(crops + k9.numel() * 4,
                2 * tw.shape[1] * width.numel()
                + 2 * th.shape[1] * k9.numel()))
    results["crop_flip_resize_w"] = dict(
        max_abs_err=0,
        ms=timed(lambda: crop_flip_resize_w(rgb, xs, ys, flip, CROP, sw,
                                            tw), 10),
        plain_ms=timed(lambda: crop_flip_resize_w_plain(
            rgb, xs, ys, flip, CROP, sw, tw), 3),
        library_ms=None,
        **bound(crops + width.numel() * 4, 2 * tw.shape[1] * width.numel()))
    phase("K9", card=card, equal_plain_chain=True, equal_per_axis=True,
          shape=list(k9.shape), source_frames=list(rgb.shape),
          taps=tw.shape[1],
          note="one launch (resize_2d's crop mode); per_axis_ms: K9's "
               "width pass then K8's height pass, the route of windows no "
               "tile holds (width_pass: that pass alone, at this shape)",
          width_pass=results["crop_flip_resize_w"],
          **results["crop_flip_resize"])
    k10_build = k10_info(tuple(k9.shape), AUGMENT, dev)
    if not torch.equal(outk.cpu(), augment_fused_lanes(
            k9.cpu(), aug.to("cpu"), AUGMENT, k10_build["plan"])):
        raise AssertionError("K10 differs from the plain chain on its "
                             "lane-order model's mean")
    no_contrast = {k: v for k, v in AUGMENT.items() if k != "contrast_s"}
    aug_nc = draw_augment(torch.Generator().manual_seed(10), TRAIN_N, SIZE,
                          SIZE, no_contrast).to(dev)
    out_nc = augment_fused(k9, aug_nc, no_contrast)
    if not torch.equal(out_nc, augment_fused_plain(k9, aug_nc, no_contrast)):
        raise AssertionError("K10 with contrast off differs from its plain "
                             "version")
    del out_nc
    results["augment"] = dict(
        max_abs_err=float((outk - outp).abs().max()),
        ms=timed(lambda: augment_fused(k9, aug, AUGMENT), 10),
        plain_ms=timed(lambda: augment_fused_plain(k9, aug, AUGMENT), 3),
        library_ms=None, build=k10_build,
        contrast_off=dict(
            ms=timed(lambda: augment_fused(k9, aug_nc, no_contrast), 10),
            build=k10_info(tuple(k9.shape), no_contrast, dev),
            **bound(k9.numel() * 4 * 2, k9.numel() * 10)),
        **bound(k9.numel() * 4 * 2, k9.numel() * 12))
    phase("K10", card=card, limit=K10_TOL, shape=list(outk.shape),
          deterministic=torch.equal(outk, augment_fused(k9, aug, AUGMENT)),
          equal_lanes_model=True,
          note="bound: one read and one write of the batch (the kernel "
               "reads it twice: the per-image sum, then the chain); "
               "equal_lanes_model: bit for bit the plain chain on "
               "augment_sum_lanes' contrast mean; contrast_off: the chain "
               "alone, bit for bit the plain version", **results["augment"])
    h_dense = torch.as_tensor(resize_weights(SIZE, CROP, ti.filter,
                                             ti.fscale), device=dev)
    k9_cols = width.view(TRAIN_N, CROP, SIZE * 3)
    with full_fp32():
        k8h_lib = timed(lambda: torch.matmul(h_dense, k9_cols), 10)
    k8h = dict(ms=timed(lambda: resize_axis(width, sh, th, -3), 10),
               plain_ms=timed(lambda: resize_axis_windowed_plain(
                   width, sh, th, -3), 3),
               library_ms=k8h_lib,
               **bound(width.numel() * 4 + k9.numel() * 4,
                       2 * th.shape[1] * k9.numel()))
    phase("K8_height_ingest", card=card, shape=list(k9.shape),
          note="K9's per-axis route's height pass on its width pass at the "
               "ingest's shape (the ingest itself takes K9's one launch); "
               "library_ms: dense torch.matmul (224 x 192 weights)", **k8h)
    del first, k9, k9p, outk, outp, rgb, k9_cols, width

    # a step without augment, held to a host anchor
    ti_a = make(augment=None, seed=1)
    reset_launch_counts()
    out = ti_a.__next__()
    torch.cuda.synchronize()
    a_counts = launch_counts()
    if a_counts["augment"] or any(a_counts[name] == 0
                                  for name in ingest_path[:-1]):
        raise AssertionError(f"anchor step launches: {a_counts}")
    check_out(out, "anchor step")
    epoch, pos, bufs = step_of(ti_a)
    groups, windows = ti_a.plan(epoch, pos, bufs)
    flips = groups[0][3].flip
    win_cpu = tuple(tuple(t.cpu() for t in w) for w in ti_a._windows)
    anchor = []
    for i in range(4):
        img = np.asarray(Image.open(io.BytesIO(bufs[i])).convert("RGB"))
        x, y = int(windows[i, 0]), int(windows[i, 1])
        crop = img[y:y + CROP, x:x + CROP]
        if bool(flips[i]):
            crop = crop[:, ::-1]
        t = torch.from_numpy(np.ascontiguousarray(crop))[None]
        (sw_c, tw_c), (sh_c, th_c) = win_cpu
        ref = resize_axis_windowed_plain(
            resize_axis_windowed_plain(t, sw_c, tw_c, -2), sh_c, th_c,
            -3).clamp(0.0, 1.0)[0]
        anchor.append(float((out[i].cpu() - ref).abs().mean()) * 255)
    if max(anchor) > ANCHOR_LSB:
        raise AssertionError(f"ingest vs host anchor: {anchor} (1/255)")
    phase("training_anchor", card=card, images=4,
          lsb_vs_host_mean=anchor, limit_lsb=ANCHOR_LSB, launches=a_counts,
          flips=[bool(f) for f in flips[:4]],
          windows=windows[:4].tolist())
    del out

    # pre_crop=False: offsets from the port's generator, 16 images
    ti_p = make(items=corpus[:16], batch=16, pre_crop=False)
    out = ti_p.__next__()
    check_out(out, "pre_crop=False", n=16)
    epoch, pos, bufs = step_of(ti_p)
    _k9, _k9p, outk, outp, _in = chains(ti_p, epoch, pos, bufs)
    err_p = float((outk - outp).abs().max())
    if not torch.equal(outk, out) or err_p > K10_TOL \
            or ti_p.scan_fallbacks:
        raise AssertionError(f"pre_crop=False: {err_p}, fallbacks "
                             f"{ti_p.scan_fallbacks}")
    phase("training_no_pre_crop", card=card, images=16,
          max_abs_vs_plain=err_p,
          scan_fallbacks=ti_p.scan_fallbacks)
    del out, _k9, _k9p, outk, outp, _in

    # K9's per-axis route: a crop no tile holds (1024 -> 64), 16 images;
    # its launches are those of K9's width pass and K8's per-axis kernel
    ti_x = make(items=corpus[:16], batch=16, crop=AXIS_CROP, size=AXIS_SIZE)
    reset_launch_counts()
    out = ti_x.__next__()
    torch.cuda.synchronize()
    x_counts = launch_counts()
    if x_counts["crop_flip_resize"] or any(x_counts[name] == 0
                                           for name in per_axis):
        raise AssertionError(f"per-axis route launches: {x_counts}")
    check_out(out, "per-axis route", n=16, size=AXIS_SIZE)
    epoch, pos, bufs = step_of(ti_x)
    _k9, _k9p, outk, outp, _in = chains(ti_x, epoch, pos, bufs)
    err_x = float((outk - outp).abs().max())
    if not torch.equal(outk, out) or err_x > K10_TOL \
            or ti_x.scan_fallbacks:
        raise AssertionError(f"per-axis route: {err_x}, fallbacks "
                             f"{ti_x.scan_fallbacks}")
    phase("training_per_axis_route", card=card, images=16, crop=AXIS_CROP,
          size=AXIS_SIZE,
          plan=crop_kernel_info(_in[0], AXIS_CROP, ti_x._windows)["plan"],
          max_abs_vs_plain=err_x, launches={k: x_counts[k]
                                            for k in per_axis})
    del out, _k9, _k9p, outk, outp, _in

    # 7. where one ingest step's time goes
    kron = torch.as_tensor(_idct_kron()).to(dev)
    k7_check = {}

    def stages_once(ti, epoch, check=False):
        """The stages of epoch `epoch`'s first step, one by one. With
        `check`, K7's output must equal its plain version's on the same
        planes (max |diff| and the plain version's ms into k7_check), and
        the frames of the hand-built chain must equal those of the
        ingest's own entry (`TrainingInput.decode`: decode_scan,
        split_planes, build_decode_stage) on the same scans."""
        perm = np.random.default_rng((ti.seed, epoch)).permutation(TRAIN_N)
        bufs = [ti.items[i] for i in perm]
        host, t = {}, time.perf_counter()
        groups, windows = ti.plan(epoch, 0, bufs)
        host["parse_and_draws"], t = ((time.perf_counter() - t) * 1e3,
                                      time.perf_counter())
        sig, _idxs, items, draws = groups[0]
        ks, wire = scan_wire(items)
        host["wire"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        buf = torch.from_numpy(wire).pin_memory().to(dev, non_blocking=True)
        xs = torch.as_tensor(windows[:, 0]).to(dev)
        ys_win = torch.as_tensor(windows[:, 1]).to(dev)
        flip, aug = draws.flip.to(dev), draws.aug.to(dev)
        torch.cuda.synchronize()
        host["upload"] = (time.perf_counter() - t) * 1e3
        comp_of = torch.as_tensor(mcu_slot_tables(sig[3])).to(dev,
                                                               torch.int32)
        split_idx = [torch.as_tensor(i).to(dev, torch.int64)
                     for i in split_indices(sig[3])]
        if ks[9]:
            raise AssertionError("the ingest corpus took the restart path")
        geom = plane_geometry(sig[3], sig[0], sig[1])
        # decode_scan's chunked path (K4, K5) and the decode stage (K6 a
        # component, K7), a CUDA event after each kernel
        names = (["K4", "K5", "split"]
                 + [f"K6_{c}" for c in range(len(geom))]
                 + ["K7", "K9", "K10"])
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        at = iter(ev)
        next(at).record()
        dargs, qt = wire_unpack(buf, ks, len(sig[3]))
        coefs, ok, _passes = _decode_scan_chunked_kernel(dargs, ks, comp_of,
                                                         MAX_PASSES)
        next(at).record()
        coefs = dc_integrate(coefs, comp_of, dargs.ri_blk, ks[5])
        next(at).record()
        planes = split_planes(coefs, sig[3], split_idx)
        del coefs
        next(at).record()
        ys = []
        for p_, q_, (dh, dw, _fx, _fy) in zip(planes, qt, geom):
            ys.append(dequant_idct_plane(p_, q_, kron, dh, dw))
            next(at).record()
        del planes
        rgb = upsample_color(ys, sig[3], sig[2], sig[0], sig[1],
                             force_rgb=True)
        next(at).record()
        f = crop_flip_resize(rgb, xs, ys_win, flip, CROP, ti._windows)
        next(at).record()
        f = augment_fused(f, aug, AUGMENT)
        next(at).record()
        torch.cuda.synchronize()
        if not bool(ok):
            raise AssertionError("stage run flagged")
        if check:
            # the plain version 64 images at a time (its int32
            # temporaries), one checked run
            del f
            err, plain_ms = 0, 0.0
            for i in range(0, rgb.shape[0], 64):
                t = time.perf_counter()
                want = upsample_color_plain([p[i:i + 64] for p in ys],
                                            sig[3], sig[2], sig[0], sig[1],
                                            force_rgb=True)
                torch.cuda.synchronize()
                plain_ms += (time.perf_counter() - t) * 1e3
                err = max(err, int((rgb[i:i + 64].to(torch.int16)
                                    - want.to(torch.int16)).abs().max()))
                del want
            if err:
                raise AssertionError(f"K7 differs from its plain version at "
                                     f"the ingest's shape by {err}")
            k7_check.update(max_abs_err=err, plain_ms=plain_ms)
            del ys
            rgb_e, ok_e = ti.decode(items)
            if not (bool(ok_e) and torch.equal(rgb, rgb_e)):
                raise AssertionError("the timed chain's frames differ from "
                                     "TrainingInput.decode's")
            del rgb_e
        return host, {n: ev[i].elapsed_time(ev[i + 1])
                      for i, n in enumerate(names)}

    ti_t = make()
    runs = [stages_once(ti_t, epoch, check=epoch == 0)
            for epoch in range(4)][1:]
    host_ms = {k: sorted(r[0][k] for r in runs)[len(runs) // 2]
               for k in runs[0][0]}
    device_ms = {k: sorted(r[1][k] for r in runs)[len(runs) // 2]
                 for k in runs[0][1]}
    torch.cuda.reset_peak_memory_stats(dev)
    ti_m = make()
    step = wall(ti_m.__next__, 3)
    peak = torch.cuda.max_memory_allocated(dev)
    # 4:2:0 planes in: luma and two half-size chroma planes
    ys_bytes = TRAIN_N * (SRC_H * SRC_W
                          + 2 * -(-SRC_H // 2) * -(-SRC_W // 2))
    results["upsample_color"]["buckets"].append(dict(
        bucket=f"the ingest's {TRAIN_N} x {SRC_W}x{SRC_H} 4:2:0 "
               f"(timing_training's K7 stage)", images=TRAIN_N,
        ms=device_ms["K7"], max_abs_err=k7_check["max_abs_err"],
        plain_ms=k7_check["plain_ms"], library_ms=None,
        **bound(ys_bytes + TRAIN_N * SRC_H * SRC_W * 3)))
    phase("timing_training", card=card, images=TRAIN_N,
          ms_per_step=step, images_per_s=TRAIN_N / step * 1e3,
          host_ms=host_ms, device_ms=device_ms,
          host_sum_ms=sum(host_ms.values()),
          device_sum_ms=sum(device_ms.values()), chain_equals_entry=True,
          idle_share=1.0 - sum(device_ms.values()) / step,
          peak_device_bytes=peak, peak_device_gb=peak / 1e9)
    return (dict(main_launches, **{k: x_counts[k] for k in per_axis}),
            sum(device_ms.values()))


class Marks:
    """The ViT's `mark` hook (forward and train step): a CUDA event after
    each stage; `ms()` sums the time between events by stage name."""

    def __init__(self):
        self.at = [("start", self._event())]

    @staticmethod
    def _event():
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, stage):
        self.at.append((stage, self._event()))

    def ms(self):
        import torch

        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.at, self.at[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def fwd_flops(c, moe_cap=None):
    """bf16 product FLOPs of one ViT forward at TRAIN_N images (the MoE's
    expert products over their whole buffers, as the batched products run
    them)."""
    t, dm, f = TRAIN_N * c.seq_len, c.dim, c.mlp_ratio * c.dim
    fl = (2 * t * (c.patch * c.patch * 3) * dm
          + 2 * TRAIN_N * dm * c.classes)
    for i in range(c.depth):
        fl += 2 * t * dm * 4 * dm + 4 * TRAIN_N * c.heads * \
            c.seq_len ** 2 * c.head_dim
        fl += (4 * c.moe_experts * moe_cap * dm * f if c.is_moe_block(i)
               else 4 * t * dm * f)
    return fl


def only(counts, want, label):
    """Raise unless the launch counts are exactly `want` (others 0)."""
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{label} launches: {got}, want {want}")
    return got


def _config4_waves(i):
    """Image i of bench.py's config-4 recipe before its noise term."""
    import numpy as np

    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W].astype(np.float32)
    base = 127 + 70 * np.sin(xx / (11 + i)) + 40 * np.cos(yy / (7 + i))
    return np.stack([base, 255 - base, base * 0.5 + 60,
                     np.full_like(base, 255) - (xx + yy) % 17], -1)


def config4_sources():
    """bench.py's config-4 recipe (seed 9): 8 RGBA 384x256 images (the
    call tiles them to IMG_N, as bench.py does)."""
    import numpy as np

    rng = np.random.default_rng(9)
    return [np.clip(_config4_waves(i) + rng.normal(0, 4, (IMG_H, IMG_W, 4)),
                    0, 255).astype(np.uint8) for i in range(8)]


def compressible_sources():
    """config4_sources' recipe without its noise term, quantised to 8
    levels a channel: what an LZW strip compresses well (long strings,
    KwKwK)."""
    import numpy as np

    return [np.clip(_config4_waves(i), 0, 255).astype(np.uint8) // 32 * 32
            for i in range(8)]


def k7_signature_buckets(dev, timed, builds=None):
    """K7 on N_IMG seeded random SRC_W x SRC_H planes of each compiled-in
    signature but h2v2 (`K7_SIGNATURES` of ops/jpeg.py, whose h2v2 is
    phase K7's own), each exactly its plain version: one record a bucket
    with a digest of the output and, where the checkout names its builds
    (`k7_build`; `builds` from `kernel_info`), the build it launches."""
    import hashlib

    import torch

    from picha_tpu_torch.ops import jpeg as jp

    out = []
    for name, (samp, cs, force) in jp.K7_SIGNATURES.items():
        if name == "h2v2":
            continue
        sig = jp.comp_sig_of(samp, SRC_W, SRC_H)
        g = torch.Generator(device=dev).manual_seed(len(name))
        planes = [torch.randint(0, 256, (N_IMG, dh, dw), generator=g,
                                device=dev, dtype=torch.uint8)
                  for dh, dw, _fx, _fy in jp.plane_geometry(sig, SRC_W,
                                                            SRC_H)]
        args = (planes, sig, cs, SRC_W, SRC_H, force)
        got = jp.upsample_color(*args)
        if not torch.equal(got, jp.upsample_color_plain(*args)):
            raise AssertionError(f"K7 ({name}) differs from its plain "
                                 f"version")
        rec = dict(
            bucket=f"{name}, {N_IMG} random {SRC_W}x{SRC_H} planes",
            max_abs_err=0, ms=timed(lambda: jp.upsample_color(*args), 10),
            plain_ms=timed(lambda: jp.upsample_color_plain(*args), 3),
            library_ms=None,
            digest=hashlib.sha256(got.cpu().numpy().tobytes()
                                  ).hexdigest()[:16],
            **bound(sum(p.numel() for p in planes) + got.numel()))
        if builds is not None:
            rec["build_name"] = jp.k7_build(sig, cs, SRC_W, SRC_H, force)
            rec["build"] = builds[rec["build_name"]]
        out.append(rec)
    return out


K13_BIG = (1088, 1920)       # the single-image K13 bucket, rgb8
K13_PLAIN_ROWS = 32          # rows of 2 images a K13 bucket checked against
                             # the plain version (a torch loop a pixel)


def k13_bucket_records(dev, unfilter, timed, info=None):
    """K13 on its buckets: config 4's sources (8 images tiled to IMG_N)
    PNG-encoded by the port (`encode_filtered`) with the default probe
    as rgba8, with strategies 4 (all Paeth), 3 (all average) and 2 (all
    up), as rgb8 (`src[..., :3]`, bpp 3), as phase 11's 16-bit rgb deep
    files (bpp 6) and as 16-bit rgba (bpp 8); and one 1920x1088 rgb8
    image alone (waves and noise, seed 5), a single big image's latency.
    Each bucket's rows come from the files' own inflated streams. The
    output of `unfilter(rows, bpp)` must equal the sources' bytes and
    the plain version's (on the first K13_PLAIN_ROWS rows of the first 2
    images: four warps' row groups at rgba8, every chunk); statuses 0.
    Returns one record a bucket: filter-type counts, a digest of the
    output, CUDA-event ms (10 launches), the bound (rows in, bytes out),
    and `info(n, h, rb, bpp)` where given."""
    import hashlib

    import numpy as np
    import torch

    from picha_tpu_torch.ops.png_unfilter import png_unfilter_plain
    from picha_tpu_torch.pipeline import encode_filtered, png_batch

    src = np.stack(config4_sources())
    rng = np.random.default_rng(5)
    bh, bw = K13_BIG
    yy, xx = np.mgrid[0:bh, 0:bw].astype(np.float32)
    big = np.stack([127 + 70 * np.sin(xx / (13 + k))
                    + 40 * np.cos(yy / (9 + k)) for k in range(3)], -1)
    big = np.clip(big + rng.normal(0, 4, big.shape), 0, 255).astype(np.uint8)
    buckets = [
        ("rgba8, default probe (config 4's PNGs)", src, None, IMG_N),
        ("rgba8, strategy 4 (all Paeth)", src, 4, IMG_N),
        ("rgba8, strategy 3 (all average)", src, 3, IMG_N),
        ("rgba8, strategy 2 (all up)", src, 2, IMG_N),
        ("rgb8, default probe", src[..., :3], None, IMG_N),
        ("rgb16, default probe (phase 11's deep files)",
         src[..., :3].astype(np.uint16) * 257, None, IMG_N),
        ("rgba16, default probe", src.astype(np.uint16) * 257, None, IMG_N),
        ("rgb8, one 1920x1088 image, default probe", big[None], None, 1),
    ]
    out = []
    for label, arr, strategy, n in buckets:
        files = encode_filtered(arr, 4, strategy, device=dev)
        raws = [png_batch.host_stage(f)[1] for f in files]
        k, h = len(files), arr.shape[1]
        rb = arr.shape[2] * arr.shape[3] * arr.itemsize
        bpp = arr.shape[3] * arr.itemsize
        tile = torch.arange(n) % k
        rows = torch.from_numpy(np.stack(raws).reshape(k, h, rb + 1))
        rows = rows.to(dev)[tile.to(dev)]
        want = torch.from_numpy(np.ascontiguousarray(
            arr.astype(arr.dtype.newbyteorder(">"))).view(np.uint8).reshape(
                k, h, rb)).to(dev)[tile.to(dev)]
        got, status = unfilter(rows, bpp)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or bool(status.any()):
            raise AssertionError(f"K13 differs from the sources ({label})")
        plain_rows, plain_n = min(h, K13_PLAIN_ROWS), min(2, n)
        t0 = time.perf_counter()
        want_p, st_p = png_unfilter_plain(rows[:plain_n, :plain_rows].cpu(),
                                          bpp)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got[:plain_n, :plain_rows].cpu(), want_p) or \
                bool(st_p.any()):
            raise AssertionError(f"K13 differs from its plain version "
                                 f"({label})")
        filt = [int(t) for t in rows[:, :, 0].reshape(-1).to(
            torch.int64).bincount(minlength=5).cpu()]
        rec = dict(bucket=label, images=n, rows=list(rows.shape), bpp=bpp,
                   filter_types=filt, equal_to_sources=True, max_abs_err=0,
                   plain_images=plain_n, plain_rows=plain_rows,
                   plain_ms=plain_ms, library_ms=None,
                   digest=hashlib.sha256(got.cpu().numpy().tobytes()
                                         ).hexdigest()[:16],
                   ms=timed(lambda: unfilter(rows, bpp), 10),
                   **bound(rows.numel() + got.numel()))
        if info is not None:
            rec["build"] = info(n, h, rb, bpp)
        out.append(rec)
        del rows, want, got, status
    return out


def pixel_phases(dev, card, results, phase, timed, wall):
    """Phases 8-10: the pixel-array path (see the module doc). Fills
    results for K11 and K12; returns their launch counts on their paths
    (K11: the config-4 call, K12: the batched PNG encode)."""
    import numpy as np
    import torch
    from PIL import Image as PILImage

    from picha_tpu_torch import Image
    from picha_tpu_torch.codecs import image_host
    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.ops.colorconvert import (convert_batch, pixel_map,
                                                  pixel_map_plain)
    from picha_tpu_torch.ops.png_filter import (filter_batch,
                                                filter_batch_plain,
                                                filter_streams)
    from picha_tpu_torch.ops.png_filter import kernel_info as k12_info
    from picha_tpu_torch.ops.resize import (resize_axis,
                                            resize_axis_windowed_plain,
                                            resize_batch, resize_windowed,
                                            window_tensors)
    from picha_tpu_torch.pipeline import ImageBatchPipeline, encode_filtered
    from picha_tpu_torch.pipeline.png_batch import assemble, filter_candidates
    from picha_tpu_torch.runtime import to_device

    srcs = config4_sources()
    tiffs = [image_host.encode_tiff(Image.from_array(a, "rgba"),
                                    {"compression": "lzw"}) for a in srcs]
    bufs = [tiffs[i % len(tiffs)] for i in range(IMG_N)]
    kw = dict(crop=IMG_CROP, resize=IMG_OUT)
    pipe = ImageBatchPipeline(encode=("image/tiff", {"compression": "lzw"}),
                              device=dev, **kw)
    pipe_w = ImageBatchPipeline(encode=("image/webp", {"quality": 85}),
                                device=dev, **kw)
    batch = pipe.decode_batch(bufs, mimetype="image/tiff")
    x = to_device(batch, dev)
    cx, cy, cw, ch = IMG_CROP
    (sw, tw), (sh, th) = pipe.windows(ch, cw)

    # 8. K11 and K12 against their plain versions -----------------------------
    def same(k, p, label):
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K11 {label} differs from its plain version")

    head = pixel_map(x, 4, torch.float32, crop=IMG_CROP)
    same(head, pixel_map_plain(x, 4, torch.float32, crop=IMG_CROP), "head")
    xh = resize_axis(resize_axis(head, sw, tw, -2), sh, th, -3)
    tail = pixel_map(xh, 4, torch.uint8)
    same(tail, pixel_map_plain(xh, 4, torch.uint8), "tail")
    norm = pixel_map(xh, 4, torch.float32, clip=True)
    same(norm, pixel_map_plain(xh, 4, torch.float32, clip=True), "normalize")
    gen = torch.Generator(device=dev).manual_seed(5)
    rgba = torch.randint(0, 256, (RC_N, 1088, 1920, 4), generator=gen,
                         device=dev, dtype=torch.uint8)
    deep = torch.randint(0, 65536, (RC_N, 1088, 1920, 4), generator=gen,
                         device=dev, dtype=torch.int32).to(torch.uint16)
    greya = convert_batch(rgba, "rgba", "greya", device=dev)
    same(greya, pixel_map_plain(rgba, 2, torch.uint8), "rgba -> greya")
    r16 = convert_batch(deep, "r16g16b16a16", "r16", device=dev)
    same(r16, pixel_map_plain(deep, 1, torch.uint16),
         "r16g16b16a16 -> r16")
    k11 = {
        "head": (lambda: pixel_map(x, 4, torch.float32, crop=IMG_CROP),
                 lambda: pixel_map_plain(x, 4, torch.float32, crop=IMG_CROP),
                 bound(head.numel() + head.numel() * 4, head.numel())),
        "tail": (lambda: pixel_map(xh, 4, torch.uint8),
                 lambda: pixel_map_plain(xh, 4, torch.uint8),
                 bound(xh.numel() * 4 + tail.numel(), 2 * tail.numel())),
        "normalize": (lambda: pixel_map(xh, 4, torch.float32, clip=True),
                      lambda: pixel_map_plain(xh, 4, torch.float32,
                                              clip=True),
                      bound(xh.numel() * 8)),
        "rgba_greya": (lambda: convert_batch(rgba, "rgba", "greya",
                                             device=dev),
                       lambda: pixel_map_plain(rgba, 2, torch.uint8),
                       bound(rgba.numel() + greya.numel(),
                             rgba.numel() + 8 * greya.numel())),
        "r16g16b16a16_r16": (lambda: convert_batch(deep, "r16g16b16a16",
                                                   "r16", device=dev),
                             lambda: pixel_map_plain(deep, 1, torch.uint16),
                             bound(deep.numel() * 2 + r16.numel() * 2,
                                   deep.numel() + 8 * r16.numel())),
    }
    k11_ms = {}
    for name, (fn, plain, bnd) in k11.items():
        k11_ms[name] = dict(ms=timed(fn, 10), plain_ms=timed(plain, 3),
                            bound_ms=bnd["bound_ms"],
                            bound_bytes=bnd["bound_bytes"])
    results["pixel_map"] = dict(
        max_abs_err=0,
        ms=k11_ms["head"]["ms"] + k11_ms["tail"]["ms"],
        plain_ms=k11_ms["head"]["plain_ms"] + k11_ms["tail"]["plain_ms"],
        library_ms=None,
        **bound(k11["head"][2]["bound_bytes"] + k11["tail"][2]["bound_bytes"],
                k11["head"][2]["bound_flops"] + k11["tail"][2]["bound_flops"]))
    phase("K11", card=card, equal=True, head_in=list(x.shape),
          head_out=list(head.shape), tail_in=list(xh.shape),
          convert_shape=list(rgba.shape), variants=k11_ms,
          note="ms, plain_ms, bound: head + tail (the config-4 call's two "
               "launches)", **results["pixel_map"])
    del norm, greya, r16, deep

    rows = tail.reshape(IMG_N, IMG_OUT[1], IMG_OUT[0] * 4)
    k12_ms, want = {}, {}
    for s in (-1, 1, 2):
        got = filter_batch(rows, 4, s)
        want[s] = filter_batch_plain(rows, 4, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want[s]):
            raise AssertionError(f"K12 strategy {s} differs from its plain "
                                 f"version")
        k12_ms[s] = dict(
            ms=timed(lambda s=s: filter_batch(rows, 4, s), 20),
            plain_ms=timed(lambda s=s: filter_batch_plain(rows, 4, s), 3),
            build=k12_info(tuple(rows.shape), 4, (s,), dev),
            **bound(rows.numel() + got.numel()))
    probe = (2, 1, -1)
    streams = filter_streams(rows, 4, probe)
    torch.cuda.synchronize()
    if not torch.equal(streams, torch.stack([want[s] for s in probe])):
        raise AssertionError("K12's probe streams differ from the plain "
                             "version's")
    results["png_filter"] = dict(
        max_abs_err=0, ms=timed(lambda: filter_streams(rows, 4, probe), 20),
        plain_ms=timed(lambda: torch.stack(
            [filter_batch_plain(rows, 4, s) for s in probe]), 3),
        library_ms=None, build=k12_info(tuple(rows.shape), 4, probe, dev),
        **bound(rows.numel() + streams.numel()))
    del streams, want
    phase("K12", card=card, equal=True, rows=list(rows.shape), bpp=4,
          strategies={str(s): v for s, v in k12_ms.items()},
          note="ms, plain_ms, build: the default probe's streams 2, 1, -1 "
               "in one launch (strategies: each alone); bound: the rows "
               "read once, the three candidate streams written once",
          **results["png_filter"])

    # 9. the config-4 call, the single-image ops, the batched PNG encode ---
    reset_launch_counts()
    outs = pipe(bufs, mimetype="image/tiff")
    torch.cuda.synchronize()
    c4 = only(launch_counts(), {"pixel_map": 2, "resize_2d": 1},
              "config-4 call")
    px = pipe.transform(batch)
    px_cpu = ImageBatchPipeline(device="cpu", **kw).transform(batch)
    if not torch.equal(px.cpu(), px_cpu):
        raise AssertionError("config 4: the card's pixels differ from the "
                             "CPU path's")

    def decode_all(files):
        ims = [PILImage.open(io.BytesIO(o)) for o in files]
        bad = [(im.size, im.mode) for im in ims
               if im.size != IMG_OUT or im.mode != "RGBA"]
        if len(files) != IMG_N or bad:
            raise AssertionError(f"config 4: {len(files)} outputs, {bad[:3]}")
        return np.stack([np.asarray(im) for im in ims])

    if not np.array_equal(decode_all(outs), px_cpu.numpy()):
        raise AssertionError("config 4: the TIFF outputs do not decode to "
                             "the transform's pixels")
    reset_launch_counts()
    outs_w = pipe_w(bufs, mimetype="image/tiff")
    torch.cuda.synchronize()
    only(launch_counts(), {"pixel_map": 2, "resize_2d": 1}, "WebP leg")
    webp_lsb = np.abs(decode_all(outs_w).astype(np.int32)
                      - px_cpu.numpy()).reshape(IMG_N, -1).mean(1)
    if webp_lsb.max() >= WEBP_LSB:
        raise AssertionError(f"config 4 WebP: {webp_lsb.max()} LSB")
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "picha_tpu" or m.startswith("picha_tpu."))
    if bad:
        raise AssertionError(f"the port imported the reference: {bad}")
    phase("image_batch", card=card, images=IMG_N,
          source=[IMG_H, IMG_W, 4], crop=list(IMG_CROP), out=list(IMG_OUT),
          launches=c4, equal_to_cpu_path=True,
          tiff_bytes=sum(len(o) for o in outs),
          webp_bytes=sum(len(o) for o in outs_w),
          webp_lsb_mean=float(webp_lsb.mean()),
          webp_lsb_max_mean=float(webp_lsb.max()), webp_limit=WEBP_LSB)

    rgb = rgba[..., :3].contiguous()
    del rgba
    reset_launch_counts()
    small = resize_batch(rgb, 960, 544, "lanczos", 1.0)
    torch.cuda.synchronize()
    rc = only(launch_counts(), {"pixel_map": 2, "resize_2d": 1},
              "resize_batch")
    (rsw, rtw), (rsh, rth) = (window_tensors(960, 1920, "lanczos", 1.0, dev),
                              window_tensors(544, 1088, "lanczos", 1.0, dev))

    def resize_plain():
        f = pixel_map_plain(rgb, 3, torch.float32)
        f = resize_axis_windowed_plain(f, rsw, rtw, -2)
        f = resize_axis_windowed_plain(f, rsh, rth, -3)
        return pixel_map_plain(f, 3, torch.uint8)

    if not torch.equal(small, resize_plain()):
        raise AssertionError("resize_batch differs from its plain path")
    reset_launch_counts()
    grey = convert_batch(rgb, "rgb", "grey", device=dev)
    torch.cuda.synchronize()
    cc = only(launch_counts(), {"pixel_map": 1}, "convert_batch")
    if not torch.equal(grey, pixel_map_plain(rgb, 1, torch.uint8)):
        raise AssertionError("convert_batch differs from its plain path")
    phase("resize_convert", card=card, shape=list(rgb.shape),
          resize_out=list(small.shape), convert_out=list(grey.shape),
          equal_to_plain=True, resize_launches=rc, convert_launches=cc,
          resize_ms=timed(lambda: resize_batch(rgb, 960, 544, "lanczos",
                                               1.0), 10),
          resize_plain_ms=timed(resize_plain, 2),
          convert_ms=timed(lambda: convert_batch(rgb, "rgb", "grey",
                                                 device=dev), 10),
          convert_plain_ms=timed(lambda: pixel_map_plain(rgb, 1,
                                                         torch.uint8), 3))
    del rgb, small, grey

    reset_launch_counts()
    pngs = encode_filtered(px, 4, None, device=dev)
    torch.cuda.synchronize()
    pe = only(launch_counts(), {"png_filter": 1}, "encode_filtered")
    back = np.stack([np.asarray(PILImage.open(io.BytesIO(b))) for b in pngs])
    if len(pngs) != IMG_N or not np.array_equal(back, px_cpu.numpy()):
        raise AssertionError("encode_filtered: a file does not decode to its "
                             "input")
    picks = [zlib.decompress(_idat(b))[0] for b in pngs]
    phase("png_encode", card=card, images=IMG_N, launches=pe,
          bytes=sum(len(b) for b in pngs),
          first_row_filter={str(f): picks.count(f) for f in sorted(set(picks))})

    # 10. where a config-4 call's time goes -----------------------------------
    def stages_once():
        host, t = {}, time.perf_counter()
        b = pipe.decode_batch(bufs, mimetype="image/tiff")
        host["decode"], t = (time.perf_counter() - t) * 1e3, time.perf_counter()
        xs = to_device(b, dev)
        torch.cuda.synchronize()
        host["upload"] = (time.perf_counter() - t) * 1e3
        names = ["K11_head", "K8_resize", "K11_tail"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        f = pixel_map(xs, 4, torch.float32, crop=IMG_CROP)
        ev[1].record()
        f = resize_windowed(f, ((sw, tw), (sh, th)))
        ev[2].record()
        out = pixel_map(f, 4, torch.uint8)
        ev[3].record()
        torch.cuda.synchronize()
        device = {n: ev[i].elapsed_time(ev[i + 1])
                  for i, n in enumerate(names)}
        t = time.perf_counter()
        arr = out.cpu().numpy()
        host["readback"], t = (time.perf_counter() - t) * 1e3, \
            time.perf_counter()
        if len(pipe.encode_batch(arr)) != IMG_N:
            raise AssertionError("stage run failed")
        host["encode_tiff"] = (time.perf_counter() - t) * 1e3
        return host, device

    runs = [stages_once() for _ in range(4)][1:]
    host_ms = {k: sorted(r[0][k] for r in runs)[1] for k in runs[0][0]}
    device_ms = {k: sorted(r[1][k] for r in runs)[1] for k in runs[0][1]}
    e2e = wall(lambda: pipe(bufs, mimetype="image/tiff"), 3)
    e2e_w = wall(lambda: pipe_w(bufs, mimetype="image/tiff"), 3)
    mpix = IMG_N * IMG_W * IMG_H / 1e6

    def png_once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _s, cands = filter_candidates(px)
        ev[1].record()
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = cands.cpu().numpy()
        t1 = time.perf_counter()
        files = assemble(host, IMG_OUT[0], 4, 4)
        t2 = time.perf_counter()
        if len(files) != IMG_N:
            raise AssertionError("png stage run failed")
        return (ev[0].elapsed_time(ev[1]), (t1 - t) * 1e3, (t2 - t1) * 1e3)

    png_runs = sorted(png_once() for _ in range(4))[1:]
    png = [sorted(r[i] for r in png_runs)[1] for i in range(3)]
    png_e2e = wall(lambda: encode_filtered(px, 4, None, device=dev), 3)
    phase("timing_image_batch", card=card, images=IMG_N,
          mpix_per_call=mpix, e2e_tiff_ms=e2e,
          e2e_tiff_mpix_s=mpix / e2e * 1e3,
          e2e_tiff_images_s=IMG_N / e2e * 1e3,
          e2e_webp_ms=e2e_w, e2e_webp_mpix_s=mpix / e2e_w * 1e3,
          e2e_webp_images_s=IMG_N / e2e_w * 1e3,
          host_ms=host_ms, device_ms=device_ms,
          host_sum_ms=sum(host_ms.values()),
          device_sum_ms=sum(device_ms.values()),
          idle_share_tiff=1.0 - sum(device_ms.values()) / e2e,
          png_encode=dict(K12_probe_ms=png[0], readback_ms=png[1],
                          host_probe_deflate_ms=png[2], e2e_ms=png_e2e,
                          images_s=IMG_N / png_e2e * 1e3),
          note="stage rows: medians of 3 runs; e2e: median of 3 calls")
    return {"pixel_map": c4["pixel_map"], "png_filter": pe["png_filter"]}


def decode_phases(dev, card, results, phase, timed, wall):
    """Phases 11-12: the batched PNG and TIFF decode (see the module
    doc). Fills results for K13-K16; returns their launch counts on the
    full-size TIFF (K15, K16) and PNG (K13, K14) calls."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image as PILImage

    from picha_tpu_torch import Image
    from picha_tpu_torch.codecs import image_host
    from picha_tpu_torch.codecs.png_host import (PNG_SIGNATURE, chunk,
                                                 ihdr)
    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.ops.lzw import check_strips, lzw_decode
    from picha_tpu_torch.ops import lzw as k15_mod
    from picha_tpu_torch.ops import png_unfilter as k13_mod
    from picha_tpu_torch.ops import png_transform as k14_mod
    from picha_tpu_torch.ops import tiff_transform as k16_mod
    from picha_tpu_torch.ops.png_transform import (png_transform,
                                                   png_transform_plain)
    from picha_tpu_torch.ops.png_unfilter import (check_status,
                                                  png_unfilter,
                                                  png_unfilter_plain)
    from picha_tpu_torch.ops.tiff_transform import (tiff_transform,
                                                    tiff_transform_plain)
    from picha_tpu_torch.pipeline import (PngBatchPipeline,
                                          TiffBatchPipeline, encode_filtered)
    from picha_tpu_torch.pipeline import png_batch, tiff_batch
    from picha_tpu_torch.runtime import upload

    def tile(files):
        return [files[i % len(files)] for i in range(IMG_N)]

    def turned_tiff(a):
        """TIFF-LZW through Pillow's libtiff with predictor 2 (tag 317)
        and orientation 6 (tag 274)."""
        out = io.BytesIO()
        PILImage.fromarray(a, "RGBA").save(out, "TIFF",
                                           compression="tiff_lzw",
                                           tiffinfo={317: 2, 274: 6})
        return out.getvalue()

    # inputs: config 4's sources as TIFF-LZW (Pillow; once plain, once
    # with predictor 2 and orientation 6), PNG (the port's encode,
    # default probe), 16-bit rgb PNG and palette + tRNS PNG
    srcs = config4_sources()
    src = np.stack(srcs)
    want8 = np.stack(tile(srcs))
    tiffs = tile([image_host.encode_tiff(Image.from_array(a, "rgba"),
                                         {"compression": "lzw"})
                  for a in srcs])
    tiffs26 = tile([turned_tiff(a) for a in srcs])
    want26 = np.ascontiguousarray(want8.transpose(0, 2, 1, 3)[:, :, ::-1])
    pngs = tile(encode_filtered(src, 4, None, device=dev))
    deep = src[..., :3].astype(np.uint16) * 257
    pngs16 = tile(encode_filtered(deep, 4, None, device=dev))
    rng = np.random.default_rng(11)
    pals = []
    for g in encode_filtered(src[..., :1], 4, None, device=dev):
        pals.append(
            PNG_SIGNATURE + chunk(b"IHDR", ihdr(IMG_W, IMG_H, 8, 3))
            + chunk(b"PLTE", rng.integers(0, 256, 768, np.uint8).tobytes())
            + chunk(b"tRNS", rng.integers(0, 256, 200, np.uint8).tobytes())
            + chunk(b"IDAT", _idat(g)) + chunk(b"IEND", b""))
    pals = tile(pals)
    tpipe = TiffBatchPipeline(device=dev)
    ppipe = PngBatchPipeline(device=dev)
    ppal = PngBatchPipeline(pixel="rgba", device=dev)

    # 11. the four kernels against their plain versions on the card's
    # inputs (K13 and K15's plain versions on the 8 distinct images);
    # K14 and K16 also on buckets whose arithmetic is not the identity of
    # the rgba buckets, K16 on rows at an unaligned byte offset, each
    # with the build of the kernel it launches ------------------------------
    sub = len(srcs)
    rb = IMG_W * 4

    def lzw_rows(items, n_plain, label):
        """One bucket's upload and K15, checked bit for bit (rows,
        lengths, statuses) against the plain version (on the host, one
        run) on the strips of its first n_plain images -> (rows, strip
        table, segments, the K15 bucket record without its time)."""
        host, lay = tiff_batch.pack(items)
        buf = upload(host, dev)
        table = buf[:lay.segs].view(torch.int64).view(4, lay.nstrips)
        segs = buf[lay.segs:lay.rows]
        rows = torch.empty((IMG_N, IMG_H, rb), dtype=torch.uint8,
                           device=dev)
        n, st = lzw_decode(segs, table[0], table[1], rows, table[2],
                           table[3])
        check_strips(n, st, table[3])
        k = sum(len(it.strips) for it in items[:n_plain])
        rows_p = torch.zeros((n_plain, IMG_H, rb), dtype=torch.uint8)
        tab_c = table[:, :k].cpu()
        t0 = time.perf_counter()
        n_p, st_p = lzw_decode(segs.cpu(), tab_c[0], tab_c[1], rows_p,
                               tab_c[2], tab_c[3])
        plain_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if not (torch.equal(rows[:n_plain].cpu(), rows_p)
                and torch.equal(n[:k].cpu(), n_p)
                and torch.equal(st[:k].cpu(), st_p)):
            raise AssertionError(f"K15 differs from its plain version "
                                 f"({label})")
        rec = dict(bucket=label, max_abs_err=0, plain_ms=plain_ms,
                   plain_images=n_plain, plain_strips=k, library_ms=None,
                   strips=lay.nstrips, segment_bytes=segs.numel(),
                   **bound(segs.numel() + rows.numel()),
                   build=k15_mod.kernel_info())
        return rows, table, segs, rec

    def k15_ms(rows, table, segs):
        return timed(lambda: lzw_decode(segs, table[0], table[1], rows,
                                        table[2], table[3]), 20)

    items = tpipe.host_stage(tiffs)
    rows, table, segs, k15 = lzw_rows(items, sub, "rgba8, predictor 1, "
                                      "orientation 1 (config 4's sources)")
    sig = items[0].sig
    rgba = tiff_transform(rows, sig)
    if not torch.equal(rgba, tiff_transform_plain(rows, sig)):
        raise AssertionError("K16 differs from its plain version")
    # 8-bit rgba, predictor 1, orientation 1: K16 is the identity here,
    # so one copy of the rows is the same function
    if not torch.equal(rgba.view_as(rows), rows):
        raise AssertionError("the rgba TIFF bucket is not the identity")
    results["lzw_decode"] = dict(ms=k15_ms(rows, table, segs), **k15)
    results["tiff_transform"] = dict(
        max_abs_err=0, ms=timed(lambda: tiff_transform(rows, sig), 10),
        plain_ms=timed(lambda: tiff_transform_plain(rows, sig), 3),
        library_ms=timed(lambda: rows.clone(), 10),
        **bound(rows.numel() + rgba.numel()),
        build=k16_mod.kernel_info(sig))
    # the same rows as a view at byte offset 5 of a larger buffer, as the
    # pipeline hands K16 the rows of uncompressed files
    flat = torch.zeros(rows.numel() + 21, dtype=torch.uint8, device=dev)
    rows5 = flat[5:5 + rows.numel()].view_as(rows)
    rows5.copy_(rows)
    rgba5 = tiff_transform(rows5, sig)
    if not torch.equal(rgba5, tiff_transform_plain(rows5, sig)) or \
            not torch.equal(rgba5, rgba):
        raise AssertionError("K16 on rows at byte offset 5 differs")
    k16_buckets = [dict(
        bucket="rgba8, predictor 1, orientation 1, rows at byte offset 5",
        max_abs_err=0, ms=timed(lambda: tiff_transform(rows5, sig), 10),
        plain_ms=timed(lambda: tiff_transform_plain(rows5, sig), 3),
        library_ms=timed(lambda: rows5.clone(), 10),
        **bound(rows5.numel() + rgba5.numel()),
        build=k16_mod.kernel_info(sig))]
    del flat, rows5, rgba5
    items26 = tpipe.host_stage(tiffs26)
    sig26 = items26[0].sig
    if sig26[5:7] != (2, 6):
        raise AssertionError(f"predictor/orientation not written: {sig26}")
    rows26, table26, segs26, k15_26 = lzw_rows(
        items26, 2, "rgba8, predictor 2, orientation 6")
    k15_26["ms"] = k15_ms(rows26, table26, segs26)
    # config 4's sources without their noise, 8 levels a channel: long
    # strings and KwKwK, so K15's expansion dominates; the rows are the
    # sources themselves (predictor 1, orientation 1)
    csrcs = compressible_sources()
    itemsc = tpipe.host_stage(tile([image_host.encode_tiff(
        Image.from_array(a, "rgba"), {"compression": "lzw"})
        for a in csrcs]))
    rowsc, tablec, segsc, k15_c = lzw_rows(
        itemsc, 2, "rgba8, compressible (no noise, 8 levels a channel)")
    if not np.array_equal(rowsc.cpu().numpy().reshape(want8.shape),
                          np.stack(tile(csrcs))):
        raise AssertionError("K15 (compressible bucket) differs from the "
                             "sources")
    k15_c["ms"] = k15_ms(rowsc, tablec, segsc)
    results["lzw_decode"]["buckets"] = [k15_26, k15_c]
    del rowsc, tablec, segsc, table26, segs26
    rgba26 = tiff_transform(rows26, sig26)
    if not torch.equal(rgba26, tiff_transform_plain(rows26, sig26)) or \
            not np.array_equal(rgba26.cpu().numpy(), want26):
        raise AssertionError("K16 (predictor 2, orientation 6) differs")
    results["tiff_transform"]["buckets"] = [dict(
        bucket="rgba8, predictor 2, orientation 6", max_abs_err=0,
        ms=timed(lambda: tiff_transform(rows26, sig26), 10),
        plain_ms=timed(lambda: tiff_transform_plain(rows26, sig26), 3),
        library_ms=None, **bound(rows26.numel() + rgba26.numel()),
        build=k16_mod.kernel_info(sig26))] + k16_buckets
    phase("K15_K16", card=card, strips=table.shape[1],
          segment_bytes=segs.numel(), rows=list(rows.shape),
          rgba=list(rgba.shape), rgba_p2_o6=list(rgba26.shape), equal=True,
          note=f"K15: kernel on all {IMG_N} images, plain (pure Python, "
               f"on the host, one run) on the {sub} distinct ones "
               f"({k15['plain_strips']} strips), bit for bit (rows, "
               f"lengths, statuses); buckets: K15 on the predictor-2 "
               f"orientation-6 files and on compressible files (no noise, "
               f"8 levels a channel; rows equal to the sources), plain on "
               f"2 images each; K16: both on all {IMG_N}, library_ms a "
               f"clone of "
               f"the rows (K16 is the identity on this bucket), buckets: "
               f"K16 on the predictor-2 orientation-6 files, equal to the "
               f"turned sources, and on the rows at byte offset 5 (library "
               f"a clone of that view); build: the launched kernel's "
               f"registers, spill bytes, shared bytes and blocks an SM",
          K15=results["lzw_decode"], K16=results["tiff_transform"])
    del rows, rgba, rows26, rgba26

    parts = ppipe.host_stage(pngs)
    phost, groups, _tables = png_batch.pack(parts)
    pbuf = upload(phost, dev)
    prows = pbuf[:groups[0][3] * IMG_N].view(IMG_N, IMG_H, rb + 1)
    plane, st13 = png_unfilter(prows, 4)
    check_status(st13)
    prows_c = prows[:sub].cpu()
    t0 = time.perf_counter()     # the plain version's one (checked) run
    plane_p, st_p = png_unfilter_plain(prows_c, 4)
    k13_plain = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if not torch.equal(plane[:sub].cpu(), plane_p) or bool(st_p.any()):
        raise AssertionError("K13 differs from its plain version")
    samples = png_batch.unpack_samples(plane, IMG_W, 4, 8)
    px = png_transform(samples, 6, 8, "rgba")
    if not torch.equal(px, png_transform_plain(samples, 6, 8, "rgba")):
        raise AssertionError("K14 differs from its plain version")
    # colour type 6 at depth 8 to rgba: K14 is the identity here
    if not torch.equal(px, samples):
        raise AssertionError("the rgba PNG bucket is not the identity")
    filt = [int(t) for t in prows[:, :, 0].reshape(-1).to(
        torch.int64).bincount(minlength=5).cpu()]
    results["png_unfilter"] = dict(
        max_abs_err=0, ms=timed(lambda: png_unfilter(prows, 4), 10),
        plain_ms=k13_plain, library_ms=None,
        **bound(prows.numel() + plane.numel()),
        build=k13_mod.kernel_info(IMG_N, IMG_H, rb, 4),
        buckets=k13_bucket_records(dev, png_unfilter, timed,
                                   k13_mod.kernel_info)[1:])
    results["png_transform"] = dict(
        max_abs_err=0,
        ms=timed(lambda: png_transform(samples, 6, 8, "rgba"), 10),
        plain_ms=timed(lambda: png_transform_plain(samples, 6, 8, "rgba"),
                       3),
        library_ms=timed(lambda: samples.clone(), 10),
        **bound(samples.numel() + px.numel()),
        build=k14_mod.kernel_info(6, 8, "rgba"))
    del plane, samples, px
    pparts = ppal.host_stage(pals)
    phost, groups, tables = png_batch.pack(pparts)
    pbuf = upload(phost, dev)
    samples, statuses = png_batch.unfilter_groups(pbuf, pparts, groups)
    check_status(*statuses)
    pal = pbuf[tables[0]:tables[0] + IMG_N * 768].view(IMG_N, 256, 3)
    trns = pbuf[tables[1]:tables[1] + IMG_N * 256].view(IMG_N, 256)
    px = png_transform(samples, 3, 8, "rgba", pal, trns)
    if not torch.equal(px, png_transform_plain(samples, 3, 8, "rgba", pal,
                                               trns)):
        raise AssertionError("K14 (palette + tRNS) differs")
    results["png_transform"]["buckets"] = [dict(
        bucket="palette + tRNS to rgba", max_abs_err=0,
        ms=timed(lambda: png_transform(samples, 3, 8, "rgba", pal, trns),
                 10),
        plain_ms=timed(lambda: png_transform_plain(samples, 3, 8, "rgba",
                                                   pal, trns), 3),
        library_ms=None,
        **bound(samples.numel() + pal.numel() + trns.numel() + px.numel()),
        build=k14_mod.kernel_info(3, 8, "rgba"))]
    del samples, px, pbuf
    # config 4's sources as 16-bit rgb, decoded deep: K14 turns the
    # big-endian sample bytes into uint16 r16g16b16
    dparts = PngBatchPipeline(deep=True, device=dev).host_stage(pngs16)
    phost, groups, _tables = png_batch.pack(dparts)
    pbuf = upload(phost, dev)
    samples, statuses = png_batch.unfilter_groups(pbuf, dparts, groups)
    check_status(*statuses)
    px = png_transform(samples, 2, 16, "r16g16b16")
    if px.dtype != torch.uint16 or not torch.equal(
            px, png_transform_plain(samples, 2, 16, "r16g16b16")) or \
            not np.array_equal(px.cpu().numpy(), np.stack(tile(list(deep)))):
        raise AssertionError("K14 (16-bit rgb, deep) differs")
    results["png_transform"]["buckets"].append(dict(
        bucket="16-bit rgb to r16g16b16 (deep)", max_abs_err=0,
        ms=timed(lambda: png_transform(samples, 2, 16, "r16g16b16"), 10),
        plain_ms=timed(lambda: png_transform_plain(samples, 2, 16,
                                                   "r16g16b16"), 3),
        library_ms=None, **bound(samples.numel() + 2 * px.numel()),
        build=k14_mod.kernel_info(2, 16, "r16g16b16")))
    phase("K13_K14", card=card, rows=list(prows.shape), bpp=4,
          filter_types=filt, equal=True,
          note=f"K13: kernel on all {IMG_N} images, plain (on the host, "
               f"one run) on the {sub} distinct ones; K13's buckets "
               f"(k13_bucket_records: strategies 4, 3, 2, rgb8, rgb16, "
               f"rgba16, one 1920x1088 rgb8 image), each equal to its "
               f"sources and, on {K13_PLAIN_ROWS} rows of 2 images, to the "
               f"plain version; K14: both on all "
               f"{IMG_N}, library_ms a clone of the samples (K14 is the "
               f"identity on this bucket), buckets: K14 on the palette + "
               f"tRNS files and on the 16-bit rgb files decoded deep (equal "
               f"to the sources); build: the launched kernel's registers, "
               f"spill bytes, shared bytes and blocks an SM",
          K13=results["png_unfilter"], K14=results["png_transform"])
    del samples, px, pbuf

    # 12. the pipelines at full size, checked, then timed -------------------
    reset_launch_counts()
    got = tpipe(tiffs)
    torch.cuda.synchronize()
    tl = only(launch_counts(), {"lzw_decode": 1, "tiff_transform": 1},
              "TiffBatchPipeline")
    pil = np.stack(tile([image_host.decode_tiff(b).to_array()
                         for b in tiffs[:sub]]))
    if tpipe.fallbacks or not np.array_equal(got.cpu().numpy(), pil) or \
            not np.array_equal(pil, want8):
        raise AssertionError("TiffBatchPipeline differs from decode_tiff")
    reset_launch_counts()
    got = tpipe(tiffs26)
    torch.cuda.synchronize()
    only(launch_counts(), {"lzw_decode": 1, "tiff_transform": 1},
         "predictor-2 orientation-6 TIFF bucket")
    if tpipe.fallbacks or not np.array_equal(got.cpu().numpy(), want26):
        raise AssertionError("predictor-2 orientation-6 bucket differs")
    reset_launch_counts()
    got = ppipe(pngs)
    torch.cuda.synchronize()
    pl = only(launch_counts(), {"png_unfilter": 1, "png_transform": 1},
              "PngBatchPipeline")
    if not np.array_equal(got.cpu().numpy(), want8):
        raise AssertionError("PngBatchPipeline differs from the sources")
    reset_launch_counts()
    got16 = PngBatchPipeline(deep=True, device=dev)(pngs16)
    torch.cuda.synchronize()
    only(launch_counts(), {"png_unfilter": 1, "png_transform": 1},
         "16-bit PNG bucket")
    if got16.dtype != torch.uint16 or not np.array_equal(
            got16.cpu().numpy(), np.stack(tile(list(deep)))):
        raise AssertionError("16-bit PNG bucket differs from its sources")
    reset_launch_counts()
    gotp = ppal(pals)
    torch.cuda.synchronize()
    only(launch_counts(), {"png_unfilter": 1, "png_transform": 1},
         "palette PNG bucket")
    wantp = np.stack(tile([np.asarray(PILImage.open(io.BytesIO(b)).convert(
        "RGBA")) for b in pals[:sub]]))
    if not np.array_equal(gotp.cpu().numpy(), wantp):
        raise AssertionError("palette + tRNS bucket differs from Pillow")
    phase("decode_batch", card=card, images=IMG_N,
          source=[IMG_H, IMG_W, 4], tiff_launches=tl, png_launches=pl,
          tiff_equal_to_decode_tiff=True, png_equal_to_sources=True,
          tiff_p2_o6_equal_to_turned_sources=True,
          png16_deep_exact=True, palette_trns_equal_to_pillow=True,
          tiff_bytes=sum(len(b) for b in tiffs),
          png_bytes=sum(len(b) for b in pngs), fallbacks=tpipe.fallbacks)

    pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="pillow")

    class Marks:
        """The pipelines' `mark` hook: the host clock and a CUDA event
        after each stage of one bucket's decode."""

        def __init__(self):
            self.at = [("start", time.perf_counter(), self._event())]

        @staticmethod
        def _event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def __call__(self, stage):
            self.at.append((stage, time.perf_counter(), self._event()))

        def ms(self):
            torch.cuda.synchronize()
            pairs = list(zip(self.at, self.at[1:]))
            return ({b[0]: (b[1] - a[1]) * 1e3 for a, b in pairs},
                    {b[0]: a[2].elapsed_time(b[2]) for a, b in pairs})

    def stages(pipe, files, decode, kernels):
        t = time.perf_counter()
        parts = pipe.host_stage(files)
        host_stage = (time.perf_counter() - t) * 1e3
        marks = Marks()
        decode(parts, marks)
        host, device = marks.ms()
        return ({"host_stage": host_stage, "pack": host["pack"],
                 "upload_enqueue": host["upload"],
                 "status_readback": host["status"]},
                {"upload": device["upload"],
                 **{name: device[k] for k, name in kernels.items()},
                 "status_readback": device["status"]})

    mpix = IMG_N * IMG_W * IMG_H / 1e6
    upload_bytes = {"tiff": len(tiff_batch.pack(items)[0]),
                    "png": len(png_batch.pack(parts)[0])}
    for label, pipe, files, decode, ks, pil_decode, nbytes in (
            ("timing_tiff_decode", tpipe, tiffs,
             lambda p, m: tiff_batch.decode_items(p, dev, m),
             {"lzw": "K15_lzw", "transform": "K16_transform"},
             image_host.decode_tiff, upload_bytes["tiff"]),
            ("timing_png_decode", ppipe, pngs,
             lambda p, m: png_batch.decode_parts(p, None, False, dev, m),
             {"unfilter": "K13_unfilter", "transform": "K14_transform"},
             image_host.decode_png, upload_bytes["png"])):
        runs = [stages(pipe, files, decode, ks) for _ in range(4)][1:]
        host_ms = {k: sorted(r[0][k] for r in runs)[1] for k in runs[0][0]}
        device_ms = {k: sorted(r[1][k] for r in runs)[1] for k in runs[0][1]}
        e2e = wall(lambda: pipe(files), 3)
        pil_ms = wall(lambda: list(pool.map(
            lambda b: pil_decode(b).to_array(), files)), 3)
        phase(label, card=card, images=IMG_N, mpix_per_call=mpix,
              upload_bytes=nbytes, host_ms=host_ms, device_ms=device_ms,
              device_sum_ms=sum(device_ms.values()), e2e_ms=e2e,
              e2e_images_s=IMG_N / e2e * 1e3, e2e_mpix_s=mpix / e2e * 1e3,
              idle_share=1.0 - sum(device_ms.values()) / e2e,
              pillow_pool8_ms=pil_ms,
              pillow_images_s=IMG_N / pil_ms * 1e3,
              note="stages timed inside the pipeline's own decode "
                   "function (its mark hook): host clock for the host "
                   "rows (status_readback there waits for the kernels), "
                   "CUDA events for the device rows; medians of 3 runs; "
                   "e2e and Pillow (8 pool threads, the same files): "
                   "medians of 3 calls")
    pool.shutdown()
    return {**tl, **pl}


def vit_phases(dev, card, results, phase, timed, wall, ingest_device_ms):
    """Phases 13-14: the ViT that consumes the training ingest (see the
    module doc). Fills results for K17-K20; returns their launch counts
    on the dense (K17, K18) and MoE (K19, K20) forwards."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.models import vit as vit_mod
    from picha_tpu_torch.models.vit import ViT, ViTConfig
    from picha_tpu_torch.ops import attention as att_mod
    from picha_tpu_torch.ops.attention import attention, attention_plain
    from picha_tpu_torch.ops import layernorm as ln_mod
    from picha_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
    from picha_tpu_torch.ops import moe as moe_mod
    from picha_tpu_torch.ops.moe import (capacity, combine, combine_plain,
                                         route_dispatch, route_dispatch_plain)
    from picha_tpu_torch.pipeline import TrainingInput

    bf16 = torch.bfloat16
    wrappers = ("layer_norm", "attention", "route_dispatch", "combine")
    plains = dict(layer_norm=layer_norm_plain, attention=attention_plain,
                  route_dispatch=route_dispatch_plain, combine=combine_plain)

    def plain_forward(model, x):
        """The same forward through K17-K20's plain versions."""
        with mock.patch.multiple(vit_mod, **plains):
            return model(x)

    def call_args(model, x):
        """The arguments of each wrapper's first and last call in one
        forward: {name: [first, last]}."""
        got = {}

        def rec(name, fn):
            def call(*a):
                got.setdefault(name, [a, a])[1] = a
                return fn(*a)
            return call

        with mock.patch.multiple(vit_mod, **{
                k: rec(k, getattr(vit_mod, k)) for k in wrappers}):
            model(x)
        return got

    def ulp(v):
        m = v.abs().double().clamp_min(2.0 ** -126)
        return torch.exp2(torch.floor(torch.log2(m)) - 7)

    def bits(t):
        return t.view(torch.int16) if t.dtype == bf16 else t

    def check_logits(logits, want, label):
        """Logits (N, 1000) f32, finite, within 0.03 plus one bf16 ulp of
        the plain path's: the logits are bf16 values, so two paths 0.03
        apart before the head's rounding may land an ulp further apart
        (0.03125 from |4| on)."""
        if tuple(logits.shape) != (TRAIN_N, 1000) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{label}: {tuple(logits.shape)} "
                                 f"{logits.dtype}, or not finite")
        diff = (logits - want).abs()
        err = float(diff.max())
        lim = VIT_LOGIT_TOL + ulp(torch.maximum(logits.abs(), want.abs()))
        if bool((diff > lim).any()):
            raise AssertionError(f"{label}: {err} from the plain path")
        return dict(max_abs_vs_plain=err,
                    max_ulps_vs_plain=float((diff / ulp(want)).max()),
                    limit="0.03 + 1 bf16 ulp of the logit",
                    argmax_agree=float((logits.argmax(-1) == want.argmax(-1))
                                       .float().mean()),
                    max_abs_logit=float(want.abs().max()))

    # 13. the ingest's batch into the ViT-S/16 forward, dense and MoE
    srcs_nr = [(FIXTURES / f"src_nr_{i}.jpg").read_bytes() for i in range(3)]
    ti = TrainingInput([srcs_nr[i % 3] for i in range(TRAIN_N)],
                       batch=TRAIN_N, crop=CROP, size=SIZE, seed=0,
                       augment=AUGMENT, device=dev)
    images = ti.__next__()
    dense = ViT(ViTConfig(), seed=0, device=dev)
    moe = ViT(ViTConfig(moe_experts=4), seed=1, device=dev)
    cfg, mcfg = dense.cfg, moe.cfg
    torch.cuda.synchronize()

    # K17-K20 against their plain versions on the path's own inputs (the
    # first call of each in a forward; K19 also the last)
    ad = call_args(dense, images)
    a17, a18 = ad["layer_norm"][0], ad["attention"][0]
    am = call_args(moe, images)
    (a19, a19_last), a20 = am["route_dispatch"], am["combine"][0]
    x17, sc17, b17 = a17
    got, want = layer_norm(*a17), layer_norm_plain(*a17)
    d17 = (got.double() - want.double()).abs()
    ulps17 = float((d17 / ulp(torch.maximum(got.abs(), want.abs()))).max())
    if ulps17 > 1.0:
        raise AssertionError(f"K17: {ulps17} bf16 ulp from its plain version")
    # the kernel's own order of operations, in torch ops on the card
    if not torch.equal(got, ln_mod.layer_norm_lanes(*a17)):
        raise AssertionError("K17 differs from its lane-order model")
    results["vit_layernorm"] = dict(
        max_abs_err=float(d17.max()), max_ulps=ulps17, equal_to_lanes=True,
        build=ln_mod.kernel_info(x17.numel() // cfg.dim, cfg.dim)["k17"],
        ms=timed(lambda: layer_norm(*a17), 20),
        plain_ms=timed(lambda: layer_norm_plain(*a17), 5),
        library_ms=timed(lambda: F.layer_norm(
            x17, (cfg.dim,), sc17.to(bf16), b17.to(bf16), 1e-6), 20),
        **bound(x17.numel() * 4 + cfg.dim * 8, x17.numel() * 10))
    qkv18, s18 = a18
    got, want = attention(*a18), attention_plain(*a18)
    n, s, _, h, d = qkv18.shape
    d18 = (got.double() - want.double()).abs()
    row = want.view(n, s, h, d).abs().amax(-1, keepdim=True).expand(
        n, s, h, d).reshape(n, s, h * d)
    ulps18 = float((d18 / ulp(torch.maximum(got.abs(), want.abs()))).max())
    over = float((d18 - ulp(torch.maximum(got.abs(), want.abs()))
                  - ulp(row)).max())
    if over > 0:
        raise AssertionError(f"K18: {over} past 1 ulp + 1 ulp of the row")
    q, k, v = (qkv18[:, :, i].transpose(1, 2) for i in range(3))
    results["vit_attention"] = dict(
        max_abs_err=float(d18.max()), max_ulps=ulps18,
        max_ulps_of_row=float((d18 / ulp(row)).max()),
        share_differing=float((d18 > 0).double().mean()),
        ms=timed(lambda: attention(*a18), 10),
        plain_ms=timed(lambda: attention_plain(*a18), 3),
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=s18), 10),
        **bound(qkv18.numel() * 2 + got.numel() * 2,
                bf16_flops=4 * n * h * s * s * d))
    r18 = results["vit_attention"]
    r18.update(bound_share=r18["bound_ms"] / r18["ms"],
               ratio_to_library=r18["ms"] / r18["library_ms"],
               build=att_mod.kernel_info(s, d),
               sass=attention_sass(backward=False))
    del got, want, d17, d18, row, q, k, v

    def k19_case(args):
        got, want = route_dispatch(*args), route_dispatch_plain(*args)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            raise AssertionError("K19 differs from its plain version")
        logits, yt, cap = args
        t, e = logits.shape
        xe, eidx = got[0], got[1]
        return dict(
            tokens=t, experts=e, cap=cap, kept=int((eidx < e).sum()),
            per_expert=torch.bincount(eidx.long(), minlength=e + 1).tolist(),
            max_abs_err=0,
            ms=timed(lambda: moe_mod.route_dispatch_k19(*args), 10),
            autograd_call_ms=timed(lambda: route_dispatch(*args), 10),
            plain_ms=timed(lambda: route_dispatch_plain(*args), 3),
            library_ms=None, build=moe_mod.kernel_info(t, e, yt.shape[1],
                                                       dev),
            **bound(logits.numel() * 4 + yt.numel() * 2 + xe.numel() * 2
                    + t * 12, t * e * 8))

    results["moe_route_dispatch"] = k19_case(a19)
    skewed = a19[0].clone()                # every token on expert 0
    skewed[:, 0] = skewed.amax(-1) + 1.0
    sk = k19_case((skewed, a19[1], a19[2]))
    if sk["kept"] >= sk["tokens"]:
        raise AssertionError(f"the skewed router dropped nothing: {sk}")
    results["moe_route_dispatch"]["buckets"] = [
        dict(bucket="every token routed to expert 0 (drops past capacity)",
             **sk),
        dict(bucket="the last MoE block's call", **k19_case(a19_last))]
    # every MoE block's call of the forward, bit for bit
    calls = []

    def record(*a):
        calls.append(a)
        return real19(*a)

    real19 = vit_mod.route_dispatch
    with torch.no_grad(), mock.patch.object(vit_mod, "route_dispatch",
                                            record):
        moe(images)
    if not calls:
        raise AssertionError("the MoE forward called no K19")
    for i, args in enumerate(calls):
        with torch.no_grad():
            got, want = moe_mod.route_dispatch_k19(*args), \
                route_dispatch_plain(*args)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            raise AssertionError(f"K19 differs from its plain version at "
                                 f"the forward's call {i}")
    results["moe_route_dispatch"]["calls_equal_plain"] = len(calls)
    del calls, got, want
    ye20, e20, s20, g20 = a20
    got = combine(*a20)
    if not torch.equal(bits(got), bits(combine_plain(*a20))):
        raise AssertionError("K20 differs from its plain version")
    kept20 = int((e20 < mcfg.moe_experts).sum())
    results["moe_combine"] = dict(
        max_abs_err=0, ms=timed(lambda: combine(*a20), 20),
        plain_ms=timed(lambda: combine_plain(*a20), 5), library_ms=None,
        **bound(kept20 * mcfg.dim * 2 + got.numel() * 2
                + e20.numel() * 12, got.numel()))
    del got, skewed, ad, am, a19, a19_last, a20
    phase("K17_K20", card=card, tokens=TRAIN_N * cfg.seq_len, dim=cfg.dim,
          note="each kernel on the arguments of its first call in the "
               "forward (K19's buckets: a skewed router, and its last "
               "call; K19's ms: its wrapper route_dispatch_k19, "
               "autograd_call_ms: the autograd Function the forward calls, "
               "host time included; its build: ops.moe.kernel_info; "
               "calls_equal_plain: the forward's calls of K19 checked bit "
               "for bit against its plain version); K17 "
               "and K18 within 1 bf16 ulp (K18: plus 1 ulp of "
               "the row's largest |o|), K17 bit for bit its lane-order "
               "model (build: its plan and registers), K19 (expert, slot, keep, gate and "
               "buffer) and K20 bit for bit; library_ms: F.layer_norm, "
               "F.scaled_dot_product_attention",
          K17=results["vit_layernorm"], K18=results["vit_attention"],
          K19=results["moe_route_dispatch"], K20=results["moe_combine"])

    reset_launch_counts()
    logits = dense(images)
    torch.cuda.synchronize()
    dl = only(launch_counts(), {"vit_layernorm": 2 * cfg.depth + 1,
                                "vit_attention": cfg.depth},
              "dense ViT forward")
    dense_chk = check_logits(logits, plain_forward(dense, images), "dense")

    def routed(route, got):
        """`route` recording each call's (eidx, sidx) into `got`."""
        def call(*a):
            out = route(*a)
            got.append((out[1], out[2]))
            return out
        return call

    k_routes, p_routes = [], []
    reset_launch_counts()
    with mock.patch.object(vit_mod, "route_dispatch",
                           routed(vit_mod.route_dispatch, k_routes)):
        mlogits = moe(images)
    torch.cuda.synchronize()
    n_moe = sum(mcfg.is_moe_block(i) for i in range(mcfg.depth))
    ml = only(launch_counts(), {"vit_layernorm": 2 * mcfg.depth + 1,
                                "vit_attention": mcfg.depth,
                                "moe_route_dispatch": n_moe,
                                "moe_combine": n_moe}, "MoE ViT forward")
    with mock.patch.multiple(vit_mod, **{
            **plains, "route_dispatch": routed(route_dispatch_plain,
                                               p_routes)}):
        mlogits_p = moe(images)
    # a router near-tie that K17's or K18's one-ulp moves flip also moves,
    # past capacity, which later tokens of the two experts are dropped
    moe_chk = check_logits(mlogits, mlogits_p, "MoE")
    moe_chk["routes_differing"] = [int((a[0] != b[0]).sum()) for a, b in
                                   zip(k_routes, p_routes)]
    # and the plain path on the kernel path's routes (as phase 15 compares
    # the MoE's gradients), under the same bound
    with mock.patch.multiple(vit_mod, **{
            **plains, "route_dispatch": pinned_route_dispatch(k_routes)}):
        mlogits_pin = moe(images)
    moe_chk["kernel_routes"] = check_logits(mlogits, mlogits_pin,
                                            "MoE on the kernel path's routes")
    moe_chk["kept_per_block"] = [int((a[0] < mcfg.moe_experts).sum())
                                 for a in k_routes]
    # TF32 and bf16 reduced-precision sums switched on globally: the
    # forward pins both, so the logits must not move
    mm = torch.backends.cuda.matmul
    prev = (torch.get_float32_matmul_precision(),
            mm.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("high")
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        logits_rp = dense(images)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        mm.allow_bf16_reduced_precision_reduction = prev[1]
    if not torch.equal(logits_rp, logits):
        raise AssertionError("TF32 / bf16 reduced precision on globally "
                             "moved the logits")
    phase("vit_forward", card=card, images=TRAIN_N,
          input=list(images.shape), logits=list(logits.shape),
          dense=dict(launches=dl, **dense_chk),
          moe=dict(launches=ml, experts=mcfg.moe_experts,
                   moe_blocks=n_moe, capacity_factor=mcfg.capacity_factor,
                   **moe_chk),
          reduced_precision_global_identical=True)
    del logits, mlogits, mlogits_p, mlogits_pin, logits_rp, k_routes, \
        p_routes

    # 14. timing: the forward on both paths, where its time goes, memory,
    # one ingest + forward step
    def stages(model):
        runs = []
        for _ in range(4):
            m = Marks()
            model(images, m)
            runs.append(m.ms())
        runs = runs[1:]
        return {k: sorted(r[k] for r in runs)[1] for k in runs[0]}

    products = ("embed", "qkv", "proj", "mlp_in", "mlp_out", "router",
                "experts", "head")
    kernels = ("K17", "K18", "K19", "K20")
    timing = {}
    for label, model in (("dense", dense), ("moe", moe)):
        fwd = timed(lambda: model(images), 10)
        plain = timed(lambda: plain_forward(model, images), 3)
        st = stages(model)
        total = sum(st.values())
        cap = capacity(TRAIN_N * model.cfg.seq_len, model.cfg.moe_experts,
                       model.cfg.capacity_factor) if label == "moe" else None
        fl = fwd_flops(model.cfg, cap)
        timing[label] = dict(
            ms=fwd, plain_ms=plain, images_per_s=TRAIN_N / fwd * 1e3,
            plain_images_per_s=TRAIN_N / plain * 1e3,
            bf16_tflop=fl / 1e12, bound_ms=fl / BF16_FLOP_S * 1e3,
            stage_ms=st, stage_sum_ms=total,
            products_share=sum(st.get(k, 0.0) for k in products) / total,
            kernels_share=sum(st.get(k, 0.0) for k in kernels) / total,
            other_share=sum(st.get(k, 0.0) for k in ("gelu", "residual"))
            / total)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    dense(images)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    step = wall(lambda: dense(ti.__next__()), 3)
    phase("timing_vit", card=card, images=TRAIN_N, **timing,
          peak_device_bytes=peak, peak_above_resident_bytes=peak - base,
          ingest_plus_forward_ms=step,
          ingest_plus_forward_images_per_s=TRAIN_N / step * 1e3,
          ingest_device_ms=ingest_device_ms,
          idle_share=1.0 - (ingest_device_ms + timing["dense"]["ms"]) / step,
          note="ms, plain_ms: CUDA events over 10 / 3 forwards; stage_ms: "
               "medians of 3 forwards through the mark hook (products "
               "include their weights' bf16 cast, proj and mlp_out the "
               "residual add); bound_ms: bf16 product FLOPs / 989 TFLOP/s; "
               "idle_share: 1 - (phase 7's ingest device sum + the dense "
               "forward) / the wall time of one ingest step + forward")
    return {**{k: dl[k] for k in ("vit_layernorm", "vit_attention")},
            **{k: ml[k] for k in ("moe_route_dispatch", "moe_combine")}}


def train_phases(dev, card, results, phase, timed, wall, ingest_device_ms):
    """Phases 15-16: the ViT-S/16 train step fed by the ingest (see the
    module doc). Fills results for K21-K24; returns their launch counts
    in one train step (K21, K22: dense; K23, K24: MoE)."""
    import contextlib
    import math
    import os
    import tempfile
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.models import checkpoint as ckpt
    from picha_tpu_torch.models import vit as vit_mod
    from picha_tpu_torch.models.vit import (ViTConfig, init_params, loss_fn,
                                            make_train_step)
    from picha_tpu_torch.ops import attention as att_mod
    from picha_tpu_torch.ops import layernorm as ln_mod
    from picha_tpu_torch.ops import moe as moe_mod
    from picha_tpu_torch.ops.jpeg import full_fp32, full_precision
    from picha_tpu_torch.optim import tree_leaves, tree_unflatten
    from picha_tpu_torch.pipeline import TrainingInput

    bf16 = torch.bfloat16
    k21, k22 = ln_mod.layer_norm_backward, att_mod.attention_backward
    k23, k24 = moe_mod.dispatch_backward, moe_mod.combine_backward
    backwards = {"layer_norm_backward": ln_mod, "attention_backward": att_mod,
                 "dispatch_backward": moe_mod, "combine_backward": moe_mod}
    plain_ops = [
        (ln_mod, "layer_norm_k17", ln_mod.layer_norm_plain),
        (ln_mod, "layer_norm_backward", ln_mod.layer_norm_backward_plain),
        (att_mod, "attention_k18", att_mod.attention_plain),
        (att_mod, "attention_backward", att_mod.attention_backward_plain),
        (moe_mod, "route_dispatch_k19", moe_mod.route_dispatch_plain),
        (moe_mod, "combine_k20", moe_mod.combine_plain),
        (moe_mod, "dispatch_backward", moe_mod.dispatch_backward_plain),
        (moe_mod, "combine_backward", moe_mod.combine_backward_plain)]

    @contextlib.contextmanager
    def plain_path():
        """The same step through the plain versions of K17-K24: the
        autograd Functions stay, their kernel calls are patched."""
        with contextlib.ExitStack() as stack:
            for mod, name, fn in plain_ops:
                stack.enter_context(mock.patch.object(mod, name, fn))
            yield

    def ulp(v):
        m = v.abs().double().clamp_min(2.0 ** -126)
        return torch.exp2(torch.floor(torch.log2(m)) - 7)

    def bits(t):
        return t.view(torch.int16) if t.dtype == bf16 else t

    # 15. one ingest step of 256; labels from a seeded generator
    srcs_nr = [(FIXTURES / f"src_nr_{i}.jpg").read_bytes() for i in range(3)]
    ti = TrainingInput([srcs_nr[i % 3] for i in range(TRAIN_N)],
                       batch=TRAIN_N, crop=CROP, size=SIZE, seed=0,
                       augment=AUGMENT, device=dev)
    images = next(ti)
    labels = torch.randint(0, 1000, (TRAIN_N,), generator=torch.Generator()
                           .manual_seed(0)).to(dev)

    def grads(params, cfg, record=None):
        """(loss, gradients) of the step's loss at `params`, taken as
        train_step takes them; `record` collects each MoE block's (eidx,
        sidx)."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        real = vit_mod.route_dispatch

        def routed(*a):
            out = real(*a)
            if record is not None:
                record.append((out[1], out[2]))
            return out

        with mock.patch.object(vit_mod, "route_dispatch", routed), \
                full_precision():
            loss = loss_fn(tree_unflatten(params, leaves), images, labels,
                           cfg)
            g = torch.autograd.grad(loss, leaves)
        return loss.detach(), g

    def backward_args(params, cfg):
        """The arguments of each backward wrapper's first call in a step;
        K22's (attention_backward) of every call, in call order."""
        got = {}

        def rec(name, fn):
            def call(*a):
                a_ = tuple(x.detach() if isinstance(x, torch.Tensor) else x
                           for x in a)
                if name == "attention_backward":
                    got.setdefault(name, []).append(a_)
                else:
                    got.setdefault(name, a_)
                return fn(*a)
            return call

        with contextlib.ExitStack() as stack:
            for name, mod in backwards.items():
                stack.enter_context(mock.patch.object(
                    mod, name, rec(name, getattr(mod, name))))
            grads(params, cfg)
        return got


    def rel_l2(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def k21_case(a):
        x, _sc, dy = a
        got, want = k21(*a), ln_mod.layer_norm_backward_plain(*a)
        dx, wdx = got[0].double(), want[0].double()
        diff = (dx - wdx).abs()
        lim = ulp(torch.maximum(dx.abs(), wdx.abs())) + \
            2.0 ** -16 * wdx.abs().amax(-1, keepdim=True)
        if bool((diff > lim).any()):
            raise AssertionError(f"K21: dx {float((diff - lim).max())} past "
                                 f"1 bf16 ulp")
        d = x.shape[-1]
        x32 = x.double().reshape(-1, d)
        xhat = (x32 - x32.mean(-1, keepdim=True)) / x32.std(
            -1, unbiased=False, keepdim=True)
        rel = {}
        for key, g_, w_, terms in (
                ("dscale", got[1], want[1], xhat * dy.double().reshape(-1, d)),
                ("dbias", got[2], want[2], dy.double().reshape(-1, d))):
            err = (g_.double() - w_.double()).abs()
            rel[key] = float((err / terms.abs().sum(0).clamp_min(1e-30)).max())
            rel[key + "_vs_value"] = float(
                (err / w_.double().abs().clamp_min(1e-30)).max())
        if max(rel["dscale"], rel["dbias"]) > 1e-5:
            raise AssertionError(f"K21: {rel} past 1e-5")
        return dict(max_abs_err=float(diff.max()),
                    max_ulps=float((diff / ulp(torch.maximum(
                        dx.abs(), wdx.abs()))).max()), **rel)

    def vjp64(qkv, do, scale):
        """attention_backward_plain's VJP in float64 from the same bf16
        inputs: dP rounded to bf16 as the plain version rounds it (its
        f32 product) and p to bf16, nothing else rounded."""
        n, s_, _, h, d = qkv.shape
        q, k, v = (qkv[:, :, i].double() for i in range(3))
        g = do.reshape(n, s_, h, d)
        with full_fp32():
            dp = torch.einsum("nqhd,nkhd->nhqk", g.float(),
                              qkv[:, :, 2].float()).to(bf16).double()
        att = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        e = torch.exp(att - att.amax(-1, keepdim=True))
        del att
        l = e.sum(-1, keepdim=True)
        p = (e / l).float().to(bf16).double()
        ds = (dp / l - (dp * e).sum(-1, keepdim=True) / (l * l)) * e * scale
        del e, dp
        return torch.stack([torch.einsum("nhqk,nkhd->nqhd", ds, k),
                            torch.einsum("nhqk,nqhd->nkhd", ds, q),
                            torch.einsum("nhqk,nqhd->nkhd", p,
                                         g.double())], 2)

    def k22_case(a):
        """K22 against its plain version on one call's arguments: each
        value within 1 ulp + 1 ulp of its row's largest |value| (ratio:
        the largest |difference| over that bound; over: values past it);
        and both against the float64 VJP (vjp64): f64_over counts the
        values where K22 is further from it than the plain version is by
        more than the same bound."""
        got, want = k22(*a), att_mod.attention_backward_plain(*a)
        diff = (got.double() - want.double()).abs()
        row = want.abs().amax(-1, keepdim=True)
        lim = ulp(torch.maximum(got.abs(), want.abs())) + ulp(row)
        ratio = diff / lim
        ref = vjp64(*a)
        err_k, err_p = (got.double() - ref).abs(), (want.double() - ref).abs()
        del ref
        return dict(max_abs_err=float(diff.max()),
                    max_ratio=float(ratio.max()),
                    over=int((diff > lim).sum()),
                    max_ratio_dq_dk_dv=[float(ratio[:, :, i].max())
                                        for i in range(3)],
                    max_ulps_of_row=float((diff / ulp(row)).max()),
                    share_differing=float((diff > 0).double().mean()),
                    f64_over=int((err_k > err_p + lim).sum()),
                    f64_ulps_of_row=float((err_k / ulp(row)).max()),
                    f64_ulps_of_row_plain=float((err_p / ulp(row)).max()))

    def k22_calls(calls):
        """k22_case on every call of a step's backward: the first call's
        numbers, the largest ratio over the calls and each call's."""
        cases = [k22_case(a) for a in calls]
        worst = max(range(len(cases)), key=lambda i: cases[i]["max_ratio"])
        return dict(cases[0], calls=len(cases),
                    max_ratio_over_calls=cases[worst]["max_ratio"],
                    worst_call=worst,
                    over_per_call=[c["over"] for c in cases],
                    max_ratio_per_call=[c["max_ratio"] for c in cases],
                    f64_over_per_call=[c["f64_over"] for c in cases],
                    f64_ulps_of_row=max(c["f64_ulps_of_row"] for c in cases),
                    f64_ulps_of_row_plain=max(c["f64_ulps_of_row_plain"]
                                              for c in cases))

    def dp_order(calls):
        """The plain version's f32 dP = do . v^T (cuBLAS, TF32 off), on
        each call's arguments, against the same sums taken d = 0, 1, ...
        in order with one rounding each (a bf16 x bf16 product is exact
        in f32): the order in which K22 sums again the dP values whose
        bf16 rounding its tensor-core sum leaves ambiguous. Counts the
        values that differ."""
        differing, values = [], 0
        for qkv, do, _sc in calls:
            n, s_, _, h, d = qkv.shape
            g = do.reshape(n, s_, h, d).float()
            v = qkv[:, :, 2].float()
            with full_fp32():
                ref = torch.einsum("nqhd,nkhd->nhqk", g, v)
            gt, vt = g.permute(0, 2, 1, 3), v.permute(0, 2, 3, 1)
            acc = torch.zeros_like(ref)
            for i in range(d):
                acc = acc + gt[..., i:i + 1] * vt[:, :, i:i + 1, :]
            differing.append(int((acc != ref).sum()))
            values += ref.numel()
            del ref, acc
        return dict(values=values, differing_per_call=differing)

    def k23_case(a):
        dxe, eidx, _s, _l, _g = a
        got, want = k23(*a), moe_mod.dispatch_backward_plain(*a)
        if not torch.equal(bits(got[0]), bits(want[0])):
            raise AssertionError("K23: dy_t differs from its plain version")
        err = float((got[1] - want[1]).abs().max())
        if err > 1e-6 * float(want[1].abs().max()):
            raise AssertionError(f"K23: dlogits {err} past 1e-6 relative")
        e = dxe.shape[0]
        return dict(max_abs_err=err, dlogits_equal=torch.equal(got[1],
                                                               want[1]),
                    tokens=eidx.numel(), kept=int((eidx < e).sum()))

    def k24_case(a):
        got, want = k24(*a), moe_mod.combine_backward_plain(*a)
        if not torch.equal(bits(got[0]), bits(want[0])):
            raise AssertionError("K24: dye differs from its plain version")
        err = float((got[1] - want[1]).abs().max())
        if err > 1e-6 * float(want[1].abs().max()):
            raise AssertionError(f"K24: dgk {err} past 1e-6 relative")
        return dict(max_abs_err=err, dgk_equal=torch.equal(got[1], want[1]))

    models = (("dense", ViTConfig(), 0), ("moe", ViTConfig(moe_experts=4), 1))
    train = {}
    step_launches = {}
    kernel_args = {}
    for label, cfg, seed in models:
        params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
        torch.cuda.synchronize()
        # K21-K24 against their plain versions on their first call's
        # arguments in a backward (K23 also on a router that drops)
        a = backward_args(params, cfg)
        kernel_args[label] = a
        chk = {"K21": k21_case(a["layer_norm_backward"]),
               "K22": k22_calls(a["attention_backward"])}
        # K22 within its bound of the plain version on every call of the
        # dense step at seeds 0 and 2, and on the MoE step's first call;
        # on the MoE step's other calls and the dense step at seeds 3-6,
        # its excesses are recorded, and K22 is held no further than that
        # bound beyond the plain version's own distance from the float64
        # VJP (the bound is at the noise of the reference's f32 rounding
        # points where dq cancels, see PERF.md)
        k22_bad = {}
        over = chk["K22"]["over_per_call"]
        if max(over if not cfg.moe_experts else over[:1]):
            k22_bad["K22"] = over
        if not cfg.moe_experts:
            for sd in (2, 3, 4, 5, 6):
                a2 = backward_args(init_params(
                    cfg, torch.Generator().manual_seed(sd), dev), cfg)
                chk[f"K22_seed{sd}"] = k22_calls(a2["attention_backward"])
                del a2
                if sd == 2 and max(chk["K22_seed2"]["over_per_call"]):
                    k22_bad["K22_seed2"] = chk["K22_seed2"]["over_per_call"]
            # the order of the plain version's f32 dP
            chk["K22_dp_order"] = dp_order(a["attention_backward"])
            if max(chk["K22_dp_order"]["differing_per_call"]):
                k22_bad["dP order"] = chk["K22_dp_order"]
        for k, v in chk.items():
            if k.startswith("K22") and max(v.get("f64_over_per_call", [0])):
                k22_bad[k + " float64"] = v["f64_over_per_call"]
        if cfg.moe_experts:
            dxe, _e, _s, lg, dgk = a["dispatch_backward"]
            chk["K23"] = k23_case(a["dispatch_backward"])
            skewed = lg.clone()            # every token on expert 0
            skewed[:, 0] = skewed.amax(-1) + 1.0
            _x, se, ss, _g = moe_mod.route_dispatch_k19(
                skewed, torch.zeros((lg.shape[0], 8), dtype=bf16,
                                    device=dev), dxe.shape[1])
            sk = k23_case((dxe, se, ss, skewed, dgk))
            if sk["kept"] >= sk["tokens"]:
                raise AssertionError(f"the skewed router dropped nothing: "
                                     f"{sk}")
            chk["K23_skewed"] = sk
            chk["K24"] = k24_case(a["combine_backward"])
        # one step's gradients through the kernels and through the plain
        # versions on the card (the MoE's plain path on the kernel path's
        # routes; also reported on its own)
        k_routes, p_routes = [], []
        loss_k, g_k = grads(params, cfg, k_routes)
        reset_launch_counts()
        with plain_path(), contextlib.ExitStack() as stack:
            if cfg.moe_experts:
                stack.enter_context(mock.patch.object(
                    moe_mod, "route_dispatch_k19",
                    pinned_route_dispatch(k_routes)))
                stack.enter_context(mock.patch.object(
                    moe_mod, "dispatch_backward", pinned_dispatch_backward))
            loss_p, g_p = grads(params, cfg)
        torch.cuda.synchronize()
        only(launch_counts(), {}, f"{label} plain step")
        rl2 = [rel_l2(x, y) for x, y in zip(g_k, g_p)]
        names = [n for n, _ in _leaf_names(params)]
        worst = rl2.index(max(rl2))
        if max(rl2) > GRAD_RL2:
            raise AssertionError(f"{label}: gradient leaf {names[worst]} "
                                 f"{max(rl2)} from the plain path")
        grad_chk = dict(
            loss=float(loss_k), loss_plain=float(loss_p),
            max_rel_l2=max(rl2), max_rel_l2_leaf=names[worst],
            median_rel_l2=sorted(rl2)[len(rl2) // 2], leaves=len(rl2),
            limit=GRAD_RL2)
        if cfg.moe_experts:
            with plain_path():
                loss_u, g_u = grads(params, cfg, p_routes)
            ru = [rel_l2(x, y) for x, y in zip(g_k, g_u)]
            grad_chk["plain_own_routes"] = dict(
                loss=float(loss_u), max_rel_l2=max(ru),
                max_rel_l2_leaf=names[ru.index(max(ru))],
                max_rel_l2_not_router=max(
                    r for r, n in zip(ru, names) if "router" not in n),
                routes_differing=[int((x[0] != y[0]).sum()) for x, y in
                                  zip(k_routes, p_routes)])
            grad_chk["kept_per_block"] = [int((x[0] < cfg.moe_experts).sum())
                                          for x in k_routes]
            del g_u
        # three steps at TRAIN_LR on the batch, a checkpoint after the
        # second, the third again from the loaded checkpoint
        init_opt, step = make_train_step(cfg, TRAIN_LR, dev)
        p, s = params, init_opt(params)
        reset_launch_counts()
        p, s, l1 = step(p, s, images, labels)
        torch.cuda.synchronize()
        want = {"vit_layernorm": 2 * cfg.depth + 1,
                "vit_attention": cfg.depth,
                "vit_layernorm_bwd": 2 * cfg.depth + 1,
                "vit_attention_bwd": cfg.depth}
        if cfg.moe_experts:
            n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.depth))
            want.update(moe_route_dispatch=n_moe, moe_combine=n_moe,
                        moe_dispatch_bwd=n_moe, moe_combine_bwd=n_moe)
        step_launches[label] = only(launch_counts(), want,
                                    f"{label} train step")
        p, s, l2 = step(p, s, images, labels)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "step2.npz")
            ckpt.save_checkpoint(path, p, s, input_state=ti.state(), step=2)
            p3, s3, l3 = step(p, s, images, labels)
            lp, ls, inp, at = ckpt.load_checkpoint(path, params,
                                                   init_opt(params))
        rp3, rs3, rl3 = step(lp, ls, images, labels)
        losses = [float(v) for v in (l1, l2, l3)]
        if not all(math.isfinite(v) for v in losses) or \
                losses[2] >= losses[0]:
            raise AssertionError(f"{label}: losses {losses}")
        same = torch.equal(rl3, l3) and all(
            torch.equal(x, y) for x, y in zip(
                tree_leaves((rp3, rs3)), tree_leaves((p3, s3))))
        if not same or at != 2 or inp != ti.state():
            raise AssertionError(f"{label}: the resumed step 3 is not the "
                                 f"uninterrupted one ({at}, {inp})")
        train[label] = dict(launches=step_launches[label], **grad_chk,
                            losses=losses, learning_rate=TRAIN_LR,
                            resumed_step_identical=True, kernels=chk)
        if not cfg.moe_experts:
            # TF32 and bf16 reduced-precision sums switched on globally:
            # the step pins both, so the gradients must not move
            mm = torch.backends.cuda.matmul
            prev = (torch.get_float32_matmul_precision(),
                    mm.allow_bf16_reduced_precision_reduction)
            torch.set_float32_matmul_precision("high")
            mm.allow_bf16_reduced_precision_reduction = True
            try:
                _l, g_rp = grads(params, cfg)
            finally:
                torch.set_float32_matmul_precision(prev[0])
                mm.allow_bf16_reduced_precision_reduction = prev[1]
            if not all(torch.equal(x, y) for x, y in zip(g_rp, g_k)):
                raise AssertionError("TF32 / bf16 reduced precision on "
                                     "globally moved the gradients")
            train[label]["reduced_precision_global_identical"] = True
        del params, p, s, p3, s3, lp, ls, rp3, rs3, g_k, g_p
        phase("train", card=card, model=label, images=TRAIN_N,
              input=list(images.shape),
              note="K21 dx within 1 bf16 ulp (+2^-16 of the row's "
                   "largest), dscale / dbias within 1e-5 of the sum of "
                   "their terms' magnitudes; K22 within 1 ulp + 1 ulp of "
                   "the row's largest |value| on every call at seeds 0 and "
                   "2 and on the MoE step's first, elsewhere no further "
                   "from the float64 VJP than the plain version is plus "
                   "that bound; K23 / K24 gathers and scatters bit for "
                   "bit, dlogits / dgk within 1e-6 "
                   "relative; gradients vs the plain path (the MoE's on "
                   "the kernel path's routes) within 2e-2 relative L2 per "
                   "leaf; the resumed third step bit for bit the "
                   "uninterrupted one", **train[label])
        if k22_bad:       # after the phase's line, which shows each call
            raise AssertionError(f"{label}: K22 past 1 ulp + 1 ulp of the "
                                 f"row, the float64 criterion or the plain "
                                 f"dP's order, {k22_bad}")

    # the kernels' own times, bounds and yardsticks on the dense step's
    # arguments (K23, K24: the MoE step's)
    a21 = kernel_args["dense"]["layer_norm_backward"]
    a22 = kernel_args["dense"]["attention_backward"][0]
    a23 = kernel_args["moe"]["dispatch_backward"]
    a24 = kernel_args["moe"]["combine_backward"]
    x21, sc21, dy21 = a21
    d = x21.shape[-1]
    t21 = x21.numel() // d
    xl = x21.detach().clone().requires_grad_()
    wl = sc21.to(bf16).requires_grad_()
    bl = torch.zeros_like(wl).requires_grad_()
    out21 = F.layer_norm(xl, (d,), wl, bl, 1e-6)
    results["vit_layernorm_bwd"] = dict(
        max_abs_err=train["dense"]["kernels"]["K21"]["max_abs_err"],
        ms=timed(lambda: k21(*a21), 20),
        plain_ms=timed(lambda: ln_mod.layer_norm_backward_plain(*a21), 5),
        library_ms=timed(lambda: torch.autograd.grad(
            out21, (xl, wl, bl), dy21, retain_graph=True), 20),
        by_kernel=device_ms_by_kernel(lambda: k21(*a21)),
        build=ln_mod.kernel_info(t21, d),
        **bound(3 * t21 * d * 2 + 3 * d * 4, 20 * t21 * d))
    del out21, xl, wl, bl
    qkv22, do22, sc22 = a22
    n, s, _, h, hd = qkv22.shape
    q, k, v = (qkv22[:, :, i].transpose(1, 2).contiguous().requires_grad_()
               for i in range(3))
    g22 = do22.reshape(n, s, h, hd).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, scale=sc22)
        torch.autograd.grad(o, (q, k, v), g22)

    o22 = F.scaled_dot_product_attention(q, k, v, scale=sc22)
    sdpa_bwd = timed(lambda: torch.autograd.grad(
        o22, (q, k, v), g22, retain_graph=True), 10)
    results["vit_attention_bwd"] = dict(
        max_abs_err=train["dense"]["kernels"]["K22"]["max_abs_err"],
        ms=timed(lambda: k22(*a22), 5),
        plain_ms=timed(lambda: att_mod.attention_backward_plain(*a22), 3),
        library_ms=timed(sdpa_fwd_bwd, 10), library_backward_only_ms=sdpa_bwd,
        **bound(7 * qkv22.numel() // 3 * 2, bf16_flops=10 * n * h * s * s * hd))
    r22 = results["vit_attention_bwd"]
    r22.update(bound_share=r22["bound_ms"] / r22["ms"],
               ratio_to_library_backward_only=r22["ms"] / sdpa_bwd,
               build=att_mod.kernel_info(s, hd, backward=True),
               sass=attention_sass(backward=True))
    del q, k, v, g22, o22
    dxe23, e23, _s23, lg23, _g23 = a23
    ne, cap, dm = dxe23.shape
    t23 = e23.numel()
    kept = int((e23 < ne).sum())
    results["moe_dispatch_bwd"] = dict(
        max_abs_err=train["moe"]["kernels"]["K23"]["max_abs_err"],
        ms=timed(lambda: k23(*a23), 20),
        plain_ms=timed(lambda: moe_mod.dispatch_backward_plain(*a23), 3),
        library_ms=None,
        buckets=[dict(bucket="every token routed to expert 0 (drops past "
                             "capacity)", **train["moe"]["kernels"]
                      ["K23_skewed"])],
        **bound(kept * dm * 2 + t23 * dm * 2 + 2 * lg23.numel() * 4
                + t23 * 12, 15 * lg23.numel()))
    dout24, ye24, e24, _s24, _gk24 = a24
    results["moe_combine_bwd"] = dict(
        max_abs_err=train["moe"]["kernels"]["K24"]["max_abs_err"],
        ms=timed(lambda: k24(*a24), 20),
        plain_ms=timed(lambda: moe_mod.combine_backward_plain(*a24), 3),
        library_ms=None,
        **bound(dout24.numel() * 2 + int((e24 < ne).sum()) * dm * 2
                + ye24.numel() * 2 + e24.numel() * 16, 3 * dout24.numel()))
    phase("K21_K24", card=card, tokens=t21, dim=d,
          note="each kernel on the arguments of its first call in the "
               "step's backward (dense step: K21, K22; MoE step: K23, "
               "K24); K21's by_kernel: its device time by kernel "
               "(torch.profiler), build: its plan (kernel_info); "
               "library_ms: F.layer_norm's backward (autograd.grad "
               "on a kept graph), F.scaled_dot_product_attention forward + "
               "backward (library_backward_only_ms: its backward alone)",
          K21=results["vit_layernorm_bwd"], K22=results["vit_attention_bwd"],
          K23=results["moe_dispatch_bwd"], K24=results["moe_combine_bwd"])

    # 16. timing: the step on both paths, where it goes, memory, one
    # ingest + train step
    def stepper(cfg, params):
        init_opt, step = make_train_step(cfg, TRAIN_LR, dev)
        box = [params, init_opt(params)]

        def one(mark=None, x=None):
            box[0], box[1], _ = step(box[0], box[1],
                                     images if x is None else x, labels,
                                     mark=mark)
        return one

    gemm_ms = {}

    def gemm_backward_ms(shape, batch=0, f32=False, dx=True):
        """CUDA-event ms of one product's backward (dW = X^T dY, dX = dY
        W^T) at the step's shape, replayed alone on random operands."""
        key = (shape, batch, f32, dx)
        if key not in gemm_ms:
            m, kk, nn = shape
            lead = (batch,) if batch else ()
            dt = torch.float32 if f32 else bf16
            gen = torch.Generator(device=dev).manual_seed(5)
            xx = torch.randn(lead + (m, kk), generator=gen, device=dev).to(dt)
            ww = torch.randn(lead + (kk, nn), generator=gen, device=dev).to(dt)
            gg = torch.randn(lead + (m, nn), generator=gen, device=dev).to(dt)

            def run():
                with full_precision():
                    xx.transpose(-1, -2) @ gg
                    if dx:
                        gg @ ww.transpose(-1, -2)
            gemm_ms[key] = timed(run, 10)
        return gemm_ms[key]

    def products_backward_ms(cfg):
        t, dm, f = TRAIN_N * cfg.seq_len, cfg.dim, cfg.mlp_ratio * cfg.dim
        pp = cfg.patch * cfg.patch * 3
        ms = gemm_backward_ms((t, pp, dm), dx=False)      # images: no grad
        ms += gemm_backward_ms((TRAIN_N, dm, cfg.classes))
        cap_ = moe_mod.capacity(t, cfg.moe_experts, cfg.capacity_factor) \
            if cfg.moe_experts else 0
        for i in range(cfg.depth):
            ms += gemm_backward_ms((t, dm, 3 * dm))
            ms += gemm_backward_ms((t, dm, dm))
            if cfg.is_moe_block(i):
                ms += gemm_backward_ms((t, dm, cfg.moe_experts), f32=True)
                ms += gemm_backward_ms((cap_, dm, f), cfg.moe_experts)
                ms += gemm_backward_ms((cap_, f, dm), cfg.moe_experts)
            else:
                ms += gemm_backward_ms((t, dm, f))
                ms += gemm_backward_ms((t, f, dm))
        return ms

    fwd_stages = ("embed", "K17", "qkv", "K18", "proj", "mlp_in", "gelu",
                  "mlp_out", "router", "K19", "experts", "K20", "residual",
                  "head", "loss")
    timing = {}
    for label, cfg, seed in models:
        params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
        one = stepper(cfg, params)
        ms = timed(one, 5)
        with plain_path():
            plain = timed(stepper(cfg, params), 3)
        runs = []
        for _ in range(4):
            m = Marks()
            one(mark=m)
            runs.append(m.ms())
        runs = runs[1:]
        st = {k_: sorted(r[k_] for r in runs)[1] for k_ in runs[0]}
        fwd = sum(st.get(k_, 0.0) for k_ in fwd_stages)
        bwd = st["backward"]
        kern = {"K21": 25 * results["vit_layernorm_bwd"]["ms"],
                "K22": cfg.depth * results["vit_attention_bwd"]["ms"]}
        if cfg.moe_experts:
            n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.depth))
            kern["K23_K24"] = n_moe * (results["moe_dispatch_bwd"]["ms"]
                                       + results["moe_combine_bwd"]["ms"])
        prod = products_backward_ms(cfg)
        cap_ = moe_mod.capacity(TRAIN_N * cfg.seq_len, cfg.moe_experts,
                                cfg.capacity_factor) \
            if cfg.moe_experts else None
        fl = 3 * fwd_flops(cfg, cap_)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        one()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        timing[label] = dict(
            ms=ms, plain_ms=plain, images_per_s=TRAIN_N / ms * 1e3,
            plain_images_per_s=TRAIN_N / plain * 1e3,
            bf16_tflop=fl / 1e12, bound_ms=fl / BF16_FLOP_S * 1e3,
            stage_ms=st, forward_ms=fwd, backward_ms=bwd,
            optimizer_ms=st["optimizer"],
            backward_split_ms=dict(
                products_replayed=prod, **kern,
                gelu_and_the_rest=bwd - prod - sum(kern.values())),
            peak_device_bytes=peak, peak_above_resident_bytes=peak - base)
        if label == "dense":
            step_e2e = wall(lambda: one(x=next(ti)), 3)
            timing["ingest_plus_train_step_ms"] = step_e2e
            timing["ingest_plus_train_step_images_per_s"] = \
                TRAIN_N / step_e2e * 1e3
            timing["idle_share"] = 1.0 - (ingest_device_ms + ms) / step_e2e
        del params, one
    phase("timing_train", card=card, images=TRAIN_N,
          ingest_device_ms=ingest_device_ms, **timing,
          note="ms, plain_ms: CUDA events over 5 / 3 train steps (forward, "
               "backward, AdamW); stage_ms: medians of 3 steps through "
               "train_step's mark hook; backward_split_ms: each kernel's "
               "own ms x its launches per step, products_replayed = the "
               "step's backward products (dW = X^T dY, dX = dY W^T) timed "
               "alone at their shapes, gelu_and_the_rest = backward minus "
               "those; bound_ms: 3 x the forward's bf16 product FLOPs / "
               "989 TFLOP/s; idle_share: 1 - (phase 7's ingest device sum "
               "+ the dense step) / the wall time of one ingest step + "
               "train step")
    return {"vit_layernorm_bwd": step_launches["dense"]["vit_layernorm_bwd"],
            "vit_attention_bwd": step_launches["dense"]["vit_attention_bwd"],
            "moe_dispatch_bwd": step_launches["moe"]["moe_dispatch_bwd"],
            "moe_combine_bwd": step_launches["moe"]["moe_combine_bwd"]}


def median_ms(fn, reps=5):
    """The median of `reps` CUDA-event timings of one call of fn, after
    one call to warm up."""
    from picha_tpu_torch.runtime import CudaTimer

    fn()
    ts = []
    for _ in range(reps):
        with CudaTimer() as t:
            fn()
        ts.append(t.ms)
    return sorted(ts)[reps // 2]


def resnet_flops(cfg, n):
    """(bf16 convolution FLOPs, f32 head FLOPs) of one ResNet forward at
    n images, 2 a multiply-add."""
    fl, s, cin = 2 * n * cfg.image_size ** 2 * 9 * 3 * cfg.stem_channels, \
        cfg.image_size, cfg.stem_channels
    for cout in cfg.stage_channels:
        for b in range(cfg.blocks_per_stage):
            so = -(-s // 2) if b == 0 else s
            fl += 2 * n * so * so * 9 * (cin + cout) * cout
            if cin != cout:
                fl += 2 * n * so * so * cin * cout
            s, cin = so, cout
    return fl, 2 * n * cin * cfg.classes


def resnet_forward64(p, x):
    """The ResNet's `forward` with every bf16 cast replaced by float64 (the
    convolutions through the port's `_conv`, which casts the weights to
    x's dtype and pads as XLA's SAME)."""
    import torch

    from picha_tpu_torch.models import resnet as rn

    def norm(h, s):
        m = h.mean((1, 2), keepdim=True)
        v = ((h - m) ** 2).mean((1, 2), keepdim=True)
        return torch.relu((h - m) / torch.sqrt(v + 1e-5) * s)

    x = rn._conv(x, p["stem"])
    for stage in p["stages"]:
        for bi, blk in enumerate(stage):
            stride = 2 if bi == 0 else 1
            h = rn._conv(norm(x, blk["scale1"]), blk["conv1"], stride)
            h = rn._conv(norm(h, blk["scale2"]), blk["conv2"])
            if blk["proj"] is not None:
                x = rn._conv(x, blk["proj"], stride) + h
            else:
                x = x[:, ::stride, ::stride, :] + h
    return x.mean((1, 2)) @ p["head"]


def float64_ratio(got, ref, g64):
    """The float64 criterion: ||got - g64|| <= 2 ||ref - g64|| + 1e-2
    ||g64||, and where ref is within 5e-3 of g64 also ||got - ref|| <= 2e-2
    ||ref||; returns (passed, the first side over the second)."""
    got, ref, g64 = got.double(), ref.double(), g64.double()
    n64, ref_err = float(g64.norm()), float((ref - g64).norm())
    ratio = float((got - g64).norm()) / max(2 * ref_err + 1e-2 * n64, 1e-300)
    ok = ratio <= 1.0
    if ref_err <= 5e-3 * n64:
        ok = ok and float((got - ref).norm()) <= 2e-2 * float(ref.norm())
    return ok, ratio


def resnet_phases(dev, card, results, phase, timed, wall, ingest_device_ms):
    """Phases 17-18: the ResNet (ResNetConfig()) forward and train step
    fed by the ingest (see the module doc). Fills results for K25 and
    K26; returns their launch counts in one train step."""
    import contextlib
    import math
    import os
    import tempfile
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.models import checkpoint as ckpt
    from picha_tpu_torch.models import resnet as rn
    from picha_tpu_torch.ops import instance_norm as inm
    from picha_tpu_torch.optim import tree_leaves, tree_unflatten
    from picha_tpu_torch.pipeline import TrainingInput

    k25, k26 = inm.norm_relu_k25, inm.norm_relu_backward

    @contextlib.contextmanager
    def plain_path():
        """The same forward or step through K25's and K26's plain
        versions: the autograd Function stays, its kernel calls are
        patched."""
        with mock.patch.object(inm, "norm_relu_k25", inm.norm_relu_plain), \
                mock.patch.object(inm, "norm_relu_backward",
                                  inm.norm_relu_backward_plain):
            yield

    def ulp(v):
        m = v.abs().double().clamp_min(2.0 ** -126)
        return torch.exp2(torch.floor(torch.log2(m)) - 7)

    def planes(n):
        return [slice(i, i + F64_CHUNK) for i in range(0, n, F64_CHUNK)]

    # 17. one ingest step of 256 into ResNet(ResNetConfig()); labels from
    # a seeded generator
    srcs_nr = [(FIXTURES / f"src_nr_{i}.jpg").read_bytes() for i in range(3)]
    ti = TrainingInput([srcs_nr[i % 3] for i in range(TRAIN_N)],
                       batch=TRAIN_N, crop=CROP, size=SIZE, seed=0,
                       augment=AUGMENT, device=dev)
    images = next(ti)
    labels = torch.randint(0, 1000, (TRAIN_N,), generator=torch.Generator()
                           .manual_seed(0)).to(dev)
    model = rn.ResNet(rn.ResNetConfig(), seed=0, device=dev)
    cfg, params = model.cfg, model.params()
    n_norms = 2 * len(cfg.stage_channels) * cfg.blocks_per_stage
    torch.cuda.synchronize()

    def grads(params):
        """(loss, gradients) of the step's loss, taken as train_step
        takes them."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with rn.conv_pin():
            loss = rn.loss_fn(tree_unflatten(params, leaves), images, labels,
                              cfg)
            g = torch.autograd.grad(loss, leaves)
        return loss.detach(), g

    def recorded():
        """The arguments of every K25 call in a forward and of every K26
        call in its backward, in call order."""
        got = {"k25": [], "k26": []}

        def rec(key, fn):
            def call(*a):
                got[key].append(tuple(t.detach() for t in a))
                return fn(*a)
            return call

        with mock.patch.object(inm, "norm_relu_k25", rec("k25", k25)), \
                mock.patch.object(inm, "norm_relu_backward",
                                  rec("k26", k26)):
            grads(params)
        return got["k25"], got["k26"]

    def grads64(params):
        """(loss, gradients, logits) in float64, F64_CHUNK images at a
        time (an image's forward is its own: the norms are per image)."""
        leaves = [p.detach().double().requires_grad_()
                  for p in tree_leaves(params)]
        p64 = tree_unflatten(params, leaves)
        acc = [torch.zeros_like(t) for t in leaves]
        loss, logits = 0.0, []
        with rn.conv_pin():
            for sl in planes(TRAIN_N):
                lg = resnet_forward64(p64, images[sl].double())
                part = -torch.log_softmax(lg, -1).gather(
                    -1, labels[sl].long()[:, None]).sum() / TRAIN_N
                acc = [a + g for a, g in
                       zip(acc, torch.autograd.grad(part, leaves))]
                loss += float(part.detach())
                logits.append(lg.detach())
        return loss, acc, torch.cat(logits)

    def k25_case(x, scale):
        """K25 against its plain version: mu within 1e-6 of the plane's
        mean |x|, sigma within 1e-6 relative, y equal to the plain
        elementwise pass on K25's own mu and sigma, and within 1 bf16 ulp
        of the plain y plus what the mu and sigma differences move it."""
        y, mu, sg = k25(x, scale)
        wy, wmu, wsg = inm.norm_relu_plain(x, scale)
        if not torch.equal(y, inm.normalize_relu(x, scale, mu, sg)):
            raise AssertionError("K25: y is not the elementwise pass on its "
                                 "own mu and sigma")
        out = dict(max_abs_err=0.0, max_ulps=0.0, mu_err=0.0, sigma_err=0.0,
                   shape=list(x.shape))
        over = -1.0
        for sl in planes(x.shape[0]):
            xd = x[sl].double()
            dmu = (mu[sl] - wmu[sl]).double().abs()
            dsg = (sg[sl] - wsg[sl]).double().abs() / wsg[sl].double()
            out["mu_err"] = max(out["mu_err"], float(
                (dmu / xd.abs().mean((1, 2)).clamp_min(1e-30)).max()))
            out["sigma_err"] = max(out["sigma_err"], float(dsg.max()))
            d = (xd - wmu[sl].double()[:, None, None, :]).abs()
            moved = scale.double().abs() * (dmu[:, None, None, :] + d * dsg[
                :, None, None, :]) / wsg[sl].double()[:, None, None, :]
            diff = (y[sl].double() - wy[sl].double()).abs()
            u = ulp(torch.maximum(y[sl].abs(), wy[sl].abs()))
            over = max(over, float((diff - u - moved).max()))
            out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
            out["max_ulps"] = max(out["max_ulps"], float((diff / u).max()))
            del xd, d, moved, diff, u
        if over > 0 or out["mu_err"] > 1e-6 or out["sigma_err"] > 1e-6:
            raise AssertionError(f"K25 vs its plain version: {out}, {over}")
        return out

    def k26_case(a):
        """K26 against its plain version on the same inputs: dx within 1
        bf16 ulp plus 2^-16 of its plane's largest |dx|, dscale within
        1e-5 of the sum of its terms' magnitudes."""
        x, y, dy, scale, mu, sg = a
        dx, ds = k26(*a)
        wdx, wds = inm.norm_relu_backward_plain(*a)
        out = dict(max_abs_err=0.0, max_ulps=0.0, shape=list(x.shape))
        over, terms = -1.0, torch.zeros_like(ds, dtype=torch.float64)
        for sl in planes(x.shape[0]):
            g, w = dx[sl].double(), wdx[sl].double()
            diff = (g - w).abs()
            u = ulp(torch.maximum(g.abs(), w.abs()))
            over = max(over, float((diff - u - 2.0 ** -16 * w.abs().amax(
                (1, 2), keepdim=True)).max()))
            out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
            out["max_ulps"] = max(out["max_ulps"], float((diff / u).max()))
            xhat = (x[sl].double() - mu[sl].double()[:, None, None, :]) / \
                sg[sl].double()[:, None, None, :]
            terms += (xhat * dy[sl].double() * (y[sl] > 0)).abs().sum(
                (0, 1, 2))
            del g, w, diff, u, xhat
        out["dscale_err"] = float(((ds.double() - wds.double()).abs()
                                   / terms.clamp_min(1e-30)).max())
        if over > 0 or out["dscale_err"] > 1e-5:
            raise AssertionError(f"K26 vs its plain version: {out}, {over}")
        return out

    # K25 and K26 against their plain versions on the path's own inputs:
    # the first and last call of each (K25: the stem's output first; K26:
    # the last block's first)
    a25, a26 = recorded()
    if len(a25) != n_norms or len(a26) != n_norms:
        raise AssertionError(f"{len(a25)} K25 / {len(a26)} K26 calls")
    chk25 = [k25_case(*a25[0]), k25_case(*a25[-1])]
    chk26 = [k26_case(a26[-1]), k26_case(a26[0])]
    torch.cuda.synchronize()

    # the forward: launches, logits against the plain path and float64
    reset_launch_counts()
    logits = model(images)
    torch.cuda.synchronize()
    fwd_launches = only(launch_counts(), {"resnet_norm": n_norms},
                        "ResNet forward")
    with plain_path():
        logits_p = model(images)
    loss_k, g_k = grads(params)
    reset_launch_counts()
    with plain_path():
        loss_p, g_p = grads(params)
    torch.cuda.synchronize()
    only(launch_counts(), {}, "ResNet plain step")
    loss64, g64, logits64 = grads64(params)
    if tuple(logits.shape) != (TRAIN_N, cfg.classes) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"ResNet logits {tuple(logits.shape)} "
                             f"{logits.dtype}, or not finite")
    lmax = float((logits - logits_p).abs().max())
    lok, lratio = float64_ratio(logits, logits_p, logits64)
    if lmax > RESNET_LOGIT_TOL or not lok:
        raise AssertionError(f"ResNet logits {lmax} from the plain path, "
                             f"float64 ratio {lratio}")
    names = [n for n, _ in _leaf_names(params)]
    ratios = [float64_ratio(a, b, c) for a, b, c in zip(g_k, g_p, g64)]
    bad = [n for n, (ok, _r) in zip(names, ratios) if not ok]
    if bad:
        raise AssertionError(f"ResNet gradient leaves past the float64 "
                             f"criterion: {bad}")
    rel64 = [float((b.double() - c).norm() / c.norm()) for b, c in
             zip(g_p, g64)]
    worst = max(range(len(ratios)), key=lambda i: ratios[i][1])
    grad_chk = dict(
        loss=float(loss_k), loss_plain=float(loss_p), loss_float64=loss64,
        logits_max_abs_vs_plain=lmax, logits_float64_ratio=lratio,
        logits_limit=RESNET_LOGIT_TOL,
        argmax_agree=float((logits.argmax(-1) == logits_p.argmax(-1))
                           .float().mean()),
        max_ratio=ratios[worst][1], max_ratio_leaf=names[worst],
        leaves=len(ratios),
        plain_vs_float64_rel_l2=dict(min=min(rel64), max=max(rel64),
                                     median=sorted(rel64)[len(rel64) // 2]))
    del g_k, g_p, g64, logits_p, logits64
    # TF32 and bf16 reduced-precision sums switched on globally: the
    # forward pins its convolutions and head, so the logits must not move
    mm = torch.backends.cuda.matmul
    prev = (torch.get_float32_matmul_precision(),
            mm.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("high")
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        logits_rp = model(images)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        mm.allow_bf16_reduced_precision_reduction = prev[1]
    if not torch.equal(logits_rp, logits):
        raise AssertionError("TF32 / bf16 reduced precision on globally "
                             "moved the ResNet logits")
    del logits_rp
    # three steps at TRAIN_LR, a checkpoint after the second, the third
    # again from the loaded checkpoint
    init_opt, step = rn.make_train_step(cfg, TRAIN_LR, dev)
    want = {"resnet_norm": n_norms, "resnet_norm_bwd": n_norms}
    p, s = params, init_opt(params)
    losses = []
    for i in range(3):
        if i == 2:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "step2.npz")
                ckpt.save_checkpoint(path, p, s, input_state=ti.state(),
                                     step=2)
                lp, ls, inp, at = ckpt.load_checkpoint(path, params,
                                                       init_opt(params))
        reset_launch_counts()
        p, s, loss = step(p, s, images, labels)
        torch.cuda.synchronize()
        step_launches = only(launch_counts(), want, f"ResNet step {i + 1}")
        losses.append(float(loss))
    rp3, rs3, rl3 = step(lp, ls, images, labels)
    if not all(math.isfinite(v) for v in losses) or losses[2] >= losses[0]:
        raise AssertionError(f"ResNet losses {losses}")
    same = torch.equal(rl3, loss) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves((rp3, rs3)),
                                          tree_leaves((p, s))))
    if not same or at != 2 or inp != ti.state():
        raise AssertionError(f"the resumed ResNet step 3 is not the "
                             f"uninterrupted one ({at}, {inp})")
    del p, s, lp, ls, rp3, rs3
    phase("resnet", card=card, images=TRAIN_N, input=list(images.shape),
          logits=list(logits.shape), config=dict(
              image_size=cfg.image_size, stem_channels=cfg.stem_channels,
              stage_channels=list(cfg.stage_channels),
              blocks_per_stage=cfg.blocks_per_stage, classes=cfg.classes,
              parameters=sum(t.numel() for t in tree_leaves(params))),
          forward_launches=fwd_launches, step_launches=step_launches,
          K25=chk25, K26=chk26, **grad_chk, losses=losses,
          learning_rate=TRAIN_LR, resumed_step_identical=True,
          reduced_precision_global_identical=True,
          note="K25: mu within 1e-6 of the plane's mean |x|, sigma within "
               "1e-6 relative, y the plain elementwise pass on K25's own "
               "statistics and within 1 bf16 ulp of the plain y plus what "
               "those differences move it; K26 dx within 1 bf16 ulp "
               "(+2^-16 of its plane's largest), dscale within 1e-5 of "
               "the sum of its terms' magnitudes (first and last call "
               "each); logits within 0.03 of the plain path's and "
               "gradients per leaf by the float64 criterion (||k - f64|| "
               "<= 2 ||plain - f64|| + 1e-2 ||f64||; where plain is "
               "within 5e-3 of f64 also ||k - plain|| <= 2e-2 ||plain||; "
               "max_ratio is the left side over the right)")

    # the kernels' own times, bounds and yardsticks: the first and last
    # call, and the sum over a forward's / a step's 12 calls
    def k25_row(x, scale):
        n, h, w, c = x.shape
        xl = x.permute(0, 3, 1, 2)
        return dict(
            ms=timed(lambda: k25(x, scale), 10),
            plain_ms=timed(lambda: inm.norm_relu_plain(x, scale), 3),
            library_ms=timed(lambda: torch.relu(F.instance_norm(
                xl, weight=scale, eps=inm.EPS)), 10),
            **bound(x.numel() * 4 + n * c * 8 + c * 4, 8 * x.numel()))

    def k26_row(a):
        x, y, dy, scale, _m, _s = a
        n, h, w, c = x.shape
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wl = scale.detach().clone().requires_grad_()
        out = torch.relu(F.instance_norm(xl, weight=wl, eps=inm.EPS))
        gl = dy.permute(0, 3, 1, 2)
        row = dict(
            ms=timed(lambda: k26(*a), 10),
            plain_ms=timed(lambda: inm.norm_relu_backward_plain(*a), 3),
            library_ms=timed(lambda: torch.autograd.grad(
                out, (xl, wl), gl, retain_graph=True), 10),
            **bound(x.numel() * 6 + n * c * 8 + c * 8, 20 * x.numel()),
            bound_ms_with_y=bound(x.numel() * 8 + n * c * 8 + c * 8)[
                "bound_ms"])
        del out
        return row

    def builds(x):
        """K25's and K26's plans and builds at x's planes, and the bytes
        an element each moves (K25: x twice, y once; K26: x and dy twice,
        dx once)."""
        info = inm.kernel_info(x.shape[1] * x.shape[2], x.shape[3])
        info["K25"]["bytes_an_element"] = 6
        info["K26"]["bytes_an_element"] = 10
        return info

    def summed(rows):
        return dict(calls=len(rows),
                    ms=sum(r["ms"] for r in rows),
                    bound_ms=sum(r["bound_ms"] for r in rows),
                    bound_bytes=sum(r["bound_bytes"] for r in rows))

    r25 = [k25_row(*a) for a in a25]
    r26 = [k26_row(a) for a in a26]
    results["resnet_norm"] = dict(
        max_abs_err=chk25[0]["max_abs_err"], **r25[0],
        buckets=[dict(bucket="the forward's last call", shape=chk25[1][
            "shape"], max_abs_err=chk25[1]["max_abs_err"], **r25[-1]),
            dict(bucket="the 12 calls of a forward", **summed(r25))])
    results["resnet_norm_bwd"] = dict(
        max_abs_err=chk26[0]["max_abs_err"], **r26[-1],
        buckets=[dict(bucket="the backward's first call (the last block)",
                      shape=chk26[1]["shape"],
                      max_abs_err=chk26[1]["max_abs_err"], **r26[0]),
                 dict(bucket="the 12 calls of a step", **summed(r26))])
    phase("K25_K26", card=card, shape=chk25[0]["shape"],
          note="each kernel on the arguments of its call on the stem's "
               "output (256, 224, 224, 64) in a forward / a backward; "
               "buckets: the other end of the net, and the sum over the 12 "
               "calls; library_ms: F.instance_norm + relu on the "
               "channels-last NCHW view (K26: their autograd); K26's bound "
               "counts 6 bytes an element (x, dy, dx: it recomputes the "
               "ReLU's mask from x and K25's statistics and reads no y), "
               "bound_ms_with_y 8; builds: kernel_info at the stem's and "
               "the last call's planes, with the bytes an element each "
               "moves",
          K25=results["resnet_norm"], K26=results["resnet_norm_bwd"],
          builds={"stem": builds(a25[0][0]), "last": builds(a25[-1][0])})
    del a25, a26

    # 18. timing: forward and step on both paths, where the step goes,
    # memory, one ingest + train step
    def stepper():
        box = [params, init_opt(params)]

        def one(mark=None, x=None):
            box[0], box[1], _ = step(box[0], box[1],
                                     images if x is None else x, labels,
                                     mark=mark)
        return one

    def stages(one):
        runs = []
        for _ in range(4):
            m = Marks()
            one(mark=m)
            runs.append(m.ms())
        runs = runs[1:]
        return {k: sorted(r[k] for r in runs)[1] for k in runs[0]}

    conv_ms = {}

    def conv_backward_ms(h, cin, cout, k, stride, dx):
        """CUDA-event ms of one convolution's backward (data and weight
        gradients, or the weights' alone for the stem) at the step's
        shape, replayed alone on random operands under conv_pin."""
        key = (h, cin, cout, k, stride, dx)
        if key not in conv_ms:
            gen = torch.Generator(device=dev).manual_seed(5)
            x = torch.randn((TRAIN_N, h, h, cin), generator=gen, device=dev) \
                .to(torch.bfloat16).requires_grad_(dx)
            w = torch.randn((k, k, cin, cout), generator=gen, device=dev) \
                .requires_grad_()
            with rn.conv_pin():
                out = rn._conv(x, w, stride)
            g = torch.randn(out.shape, generator=gen, device=dev).to(
                torch.bfloat16)
            ins = (x, w) if dx else (w,)

            def run():
                with rn.conv_pin():
                    torch.autograd.grad(out, ins, g, retain_graph=True)
            conv_ms[key] = timed(run, 5)
            del out, x, w, g
        return conv_ms[key]

    def convs_backward_ms():
        s, cin = cfg.image_size, cfg.stem_channels
        ms = conv_backward_ms(s, 3, cin, 3, 1, False)
        for cout in cfg.stage_channels:
            for b in range(cfg.blocks_per_stage):
                stride = 2 if b == 0 else 1
                ms += conv_backward_ms(s, cin, cout, 3, stride, True)
                so = -(-s // stride)
                ms += conv_backward_ms(so, cout, cout, 3, 1, True)
                if cin != cout:
                    ms += conv_backward_ms(s, cin, cout, 1, stride, True)
                s, cin = so, cout
        return ms

    conv_fl, head_fl = resnet_flops(cfg, TRAIN_N)
    one = stepper()
    timing = dict(
        forward_ms=median_ms(lambda: model(images)),
        step_ms=median_ms(one))
    with plain_path():
        timing["plain_forward_ms"] = median_ms(lambda: model(images))
        timing["plain_step_ms"] = median_ms(stepper())
        plain_st = stages(stepper())
    st = stages(one)
    for k in ("forward", "step"):
        timing[f"{k}_images_per_s"] = TRAIN_N / timing[f"{k}_ms"] * 1e3
        timing[f"plain_{k}_images_per_s"] = \
            TRAIN_N / timing[f"plain_{k}_ms"] * 1e3
    fwd = sum(v for k, v in st.items()
              if k not in ("loss", "backward", "optimizer"))
    convs = sum(v for k, v in st.items() if k.endswith("_conv"))
    k26_step = results["resnet_norm_bwd"]["buckets"][1]["ms"]
    replay = convs_backward_ms()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    e2e = wall(lambda: one(x=next(ti)), 3)
    phase("timing_resnet", card=card, images=TRAIN_N, **timing,
          conv_tflop_forward=conv_fl / 1e12,
          forward_bound_ms=bound(0, head_fl, conv_fl)["bound_ms"],
          step_bound_ms=bound(0, 3 * head_fl, 3 * conv_fl)["bound_ms"],
          stage_ms=st, plain_stage_ms=plain_st, forward_stage_sum_ms=fwd,
          forward_convs_ms=convs, forward_K25_ms=st["K25"],
          backward_ms=st["backward"], optimizer_ms=st["optimizer"],
          backward_split_ms=dict(
              K26=k26_step, convs_replayed=replay,
              the_rest=st["backward"] - k26_step - replay),
          peak_device_bytes=peak, peak_above_resident_bytes=peak - base,
          ingest_device_ms=ingest_device_ms, ingest_plus_train_step_ms=e2e,
          ingest_plus_train_step_images_per_s=TRAIN_N / e2e * 1e3,
          idle_share=1.0 - (ingest_device_ms + timing["step_ms"]) / e2e,
          note="forward_ms, step_ms (and plain_*): medians of 5 CUDA-event "
               "timings; stage_ms: medians of 3 steps through train_step's "
               "mark hook (a conv stage includes its weights' bf16 cast "
               "and its padding); backward_split_ms: K26 = the 12 calls' "
               "own ms, convs_replayed = the step's convolution backwards "
               "timed alone at their shapes, the_rest = backward minus "
               "those; bounds: bf16 conv FLOPs / 989 TFLOP/s (+ the f32 "
               "head / 67), the step 3x; idle_share: 1 - (phase 7's ingest "
               "device sum + the step) / the wall time of one ingest step "
               "+ train step")
    return {k: step_launches[k] for k in ("resnet_norm", "resnet_norm_bwd")}


UPLOADS = ("dense", "sparse", "int8", "gap8", "gap4")
RESTORES = {"sparse": "coef_densify", "int8": "coef_int8_restore",
            "gap8": "coef_gap8_restore", "gap4": "coef_gap4_restore"}


def upload_phases(dev, card, results, phase, timed, wall, corpora, planes_k1,
                  planes_k45, scan_jpegs):
    """Phases 19-21: the host-coefficient uploads (row 8a; see the module
    doc). `corpora`: {"restart": bufs, "no_restart": bufs}; `planes_k1`,
    `planes_k45`: K1's and K4 + K5's coefficient planes of those batches;
    `scan_jpegs`: {fused: upload="scan"'s outputs on the restart corpus}.
    Fills results for K27-K30; returns their launch counts in the fused
    restart slice of their upload."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    import numpy as np
    import torch
    from PIL import Image

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.ops import coef_host, coef_restore
    from picha_tpu_torch.ops.jpeg_huffman_decode import (decode_scan,
                                                         scan_wire,
                                                         split_planes,
                                                         wire_unpack)
    from picha_tpu_torch.ops.jpeg_scan import parse_baseline
    from picha_tpu_torch.pipeline import JpegBatchPipeline
    from picha_tpu_torch.pipeline.jpeg_batch import (restore_planes,
                                                     stack_coefficients,
                                                     upload_args)

    mpix = N_IMG * SRC_W * SRC_H / 1e6
    plains = dict(densify=coef_restore.densify_plain,
                  int8_restore=coef_restore.int8_restore_plain,
                  gap8_restore=coef_restore.gap8_restore_plain,
                  gap4_restore=coef_restore.gap4_restore_plain)

    def stacked(cos):
        """Per component the (N, bh, bw, 64) planes of coefficient sets."""
        return [np.stack([co.comps[i]["coefs"] for co in cos])
                for i in range(len(cos[0].comps))]

    # 19. the host decoder: K1's (restart) and K4 + K5's (no restart)
    # coefficients bit for bit, and the numpy decoder's on 2 sources
    pool = ThreadPoolExecutor(max_workers=8)
    infos = {k: [parse_baseline(bytes(b)) for b in v]
             for k, v in corpora.items()}
    cos = {k: coef_host.entropy_decode(v, True, pool, 8)
           for k, v in infos.items()}
    for name, want in (("restart", planes_k1), ("no_restart", planes_k45)):
        for got, w in zip(stacked(cos[name]), want):
            if not np.array_equal(got.astype(np.int32), w.cpu().numpy()):
                raise AssertionError(f"host decoder differs from the device "
                                     f"decoder on the {name} corpus")
    t = time.perf_counter()
    plain = [coef_host.decode_plain(infos["restart"][i]) for i in range(2)]
    plain_s = (time.perf_counter() - t) / 2
    for p, g in zip(plain, cos["restart"]):
        if not all(np.array_equal(a["coefs"], b["coefs"])
                   for a, b in zip(p.comps, g.comps)):
            raise AssertionError("host decoder differs from decode_reference")
    one = [infos["restart"][0]]
    dec = dict(
        batch_ms=wall(lambda: coef_host.entropy_decode(
            infos["restart"], True, pool, 8), 5),
        batch_no_restart_ms=wall(lambda: coef_host.entropy_decode(
            infos["no_restart"], True, pool, 8), 5),
        one_image_segment_parallel_ms=wall(
            lambda: coef_host.entropy_decode(one, True, pool, 8), 5),
        one_image_one_thread_ms=wall(
            lambda: coef_host.decode_native(one[0], 1), 5),
        plain_ms_per_image=plain_s * 1e3)
    phase("host_decoder", card=card, images=N_IMG, threads=8,
          equal_to_K1=True, equal_to_K4_K5=True, equal_to_plain_images=2,
          **dec)

    # 20. K27-K30 against their plain versions on the wires of the restart
    # corpus, and on a q = 100 batch (corrections past int8)
    def q100(buf):
        b = io.BytesIO()
        Image.open(io.BytesIO(bytes(buf))).convert("RGB").save(
            b, "JPEG", quality=100)
        return b.getvalue()

    hi_bufs = [q100(b) for b in corpora["restart"][:4]]
    hi_cos = coef_host.entropy_decode([parse_baseline(b) for b in hi_bufs],
                                      True, pool, 8)
    checks = {}
    for upload, name in RESTORES.items():
        kwk = None
        entry = {}
        for label, batch in (("restart", cos["restart"]), ("q100", hi_cos)):
            sig, ks, args = stack_coefficients(batch, upload, native=True)
            _sig, ks_p, args_p = stack_coefficients(batch, upload)
            if ks != ks_p or not all(np.array_equal(a, b) for a, b in
                                     zip(args, args_p)):
                raise AssertionError(f"{upload}: the C++ packers' wire is not "
                                     f"the numpy packers'")
            dargs = upload_args(args, dev)
            kw = {upload + "_ks": ks}
            got, _q = restore_planes(sig, dargs, **kw)
            with mock.patch.multiple(coef_restore, **plains):
                want, _wq = restore_planes(sig, dargs, **kw)
            torch.cuda.synchronize()
            for g, w, c in zip(got, want, stacked(batch)):
                if not torch.equal(g, w) or not np.array_equal(
                        g.cpu().numpy(), c.astype(np.int32)):
                    raise AssertionError(f"{name} differs from its plain "
                                         f"version or the coefficients")
            wire = sum(a.nbytes for a in args if a.dtype != np.uint16)
            ncorr = 0
            if upload == "int8":
                ncorr = sum(int((args[3 * i + 2] != 0).sum())
                            for i in range(len(sig[3])))
            elif upload in ("gap8", "gap4"):
                parts = (coef_restore.unpack_gap8 if upload == "gap8" else
                         coef_restore.unpack_gap4)(dargs[0], ks, len(sig[3]))[0]
                ncorr = sum(int((p[-1] != 0).sum()) for p in parts)
                if upload == "gap4":
                    entry[label + "_escapes"] = sum(
                        int(((p[0] & 15) == 15).sum()) for p in parts)
            entry[label + "_corrections"] = ncorr
            entry[label + "_wire_bytes"] = int(wire)
            if label == "restart":
                kwk = (sig, dargs, kw, got)
        if upload != "sparse" and entry["q100_corrections"] == 0:
            raise AssertionError(f"{upload}: no correction on the q100 batch")
        if upload == "gap4" and not entry["restart_escapes"]:
            raise AssertionError("gap4: no escape on the corpus")
        sig, dargs, kw, got = kwk
        out_bytes = sum(g.numel() * 4 for g in got)

        def run():
            return restore_planes(sig, dargs, **kw)

        def run_plain():
            with mock.patch.multiple(coef_restore, **plains):
                return restore_planes(sig, dargs, **kw)

        library_ms = None
        if upload == "sparse":
            # one index_add_ per component on a zeroed tensor (the flat
            # indices made ahead)
            n_img = dargs[0].shape[0]
            flat = []
            for i, (bh, bw, _h, _v) in enumerate(sig[3]):
                m = bh * bw * 64
                idx, val = dargs[2 * i], dargs[2 * i + 1]
                base = torch.arange(n_img, device=dev)[:, None] * m
                flat.append(((idx.long() + base).reshape(-1),
                             val.to(torch.int32).reshape(-1),
                             torch.zeros(n_img * m, dtype=torch.int32,
                                         device=dev)))

            def lib():
                for fi, fv, z in flat:
                    z.zero_().index_add_(0, fi, fv)
            library_ms = timed(lib, 10)
        results[name] = dict(
            max_abs_err=0, ms=timed(run, 10), plain_ms=timed(run_plain, 3),
            library_ms=library_ms, launches_per_batch=len(sig[3]),
            by_kernel=device_ms_by_kernel(run),
            **bound(entry["restart_wire_bytes"] + out_bytes), **entry)
        if upload in ("gap8", "gap4"):
            results[name]["build"] = coef_restore.kernel_info()
        checks[name] = results[name]
        del dargs, got
    phase("K27_K30", card=card, images=N_IMG, q100_images=len(hi_bufs),
          note="each restore bit for bit its plain version and the host "
               "coefficients on the restart corpus's wire and on a q = 100 "
               "batch (corrections past int8); the C++ packers' wire equal "
               "to the numpy packers'; ms: the batch's 3 launches (one per "
               "component) and the wire's unpack; by_kernel: the call's "
               "device time by kernel (torch.profiler); build: K29's and "
               "K30's tile and kernels; library_ms: K27's one index_add_ per component "
               "on a zeroed tensor; K28-K30 have no one-call PyTorch "
               "counterpart", **checks)

    # 21. the slice through every upload: upload="scan"'s bytes
    kwp = dict(width=OUT_W, height=OUT_H, encode_quality=QUALITY,
               encode_backend="device", device=dev)
    slice_launches, runs = {}, {}
    pixel_kernels = {True: ("jpeg_encode_front", "huffman_encode_scan"),
                     False: ("idct_plane", "upsample_color", "resize_2d",
                             "jpeg_encode_front", "huffman_encode_scan")}
    for fused in (True, False):
        for upload in UPLOADS:
            p = JpegBatchPipeline(fused=fused, upload=upload, num_threads=8,
                                  **kwp)
            for name, bufs in corpora.items():
                reset_launch_counts()
                out = p(bufs)
                torch.cuda.synchronize()
                counts = launch_counts()
                want_k = pixel_kernels[fused] + (
                    (RESTORES[upload],) if upload in RESTORES else ())
                if any(counts[k] == 0 for k in want_k) or any(
                        counts[k] for k in ("huffman_decode_restart",
                                            "huffman_decode_chunked")):
                    raise AssertionError(f"{upload} fused={fused} {name}: "
                                         f"launches {counts}")
                same = sum(bytes(a) == bytes(b)
                           for a, b in zip(out, scan_jpegs[fused]))
                if same != N_IMG or p.scan_fallbacks:
                    raise AssertionError(f"{upload} fused={fused} {name}: "
                                         f"{N_IMG - same} outputs differ from "
                                         f"upload='scan''s, fallbacks "
                                         f"{p.scan_fallbacks}")
                if fused and name == "restart" and upload in RESTORES:
                    slice_launches[RESTORES[upload]] = counts[
                        RESTORES[upload]]
                runs[f"{upload}_fused_{fused}_{name}"] = {
                    k: v for k, v in counts.items() if v}
            p.close()
    phase("uploads_slice", card=card, images=N_IMG,
          identical_to_scan_upload=True, launches=runs)

    # where a batch's time goes, per upload, beside scan's (medians of 3)
    def stages(upload):
        p = JpegBatchPipeline(fused=True, upload=upload, num_threads=8,
                              **kwp)
        bufs = corpora["restart"]
        rows = []
        for _ in range(4):
            t0 = time.perf_counter()
            cos_ = p.entropy_decode(bufs)
            t1 = time.perf_counter()
            if upload == "scan":
                ks, wire = scan_wire(cos_)
                args = [wire]
            else:
                packed = p.stack_bucket(cos_)
                args = packed[-1]
            t2 = time.perf_counter()
            dargs = (upload_args(args, dev) if upload != "scan" else
                     [torch.from_numpy(wire).pin_memory().to(dev)])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            if upload == "scan":
                sig = (cos_[0].width, cos_[0].height, cos_[0].color_space,
                       cos_[0].comp_sig)
                consts = p.constants(sig)
                dec, qt = wire_unpack(dargs[0], ks, len(sig[3]))
                coefs, _ok = decode_scan(dec, ks, consts.comp_of)
                split_planes(coefs, sig[3], consts.split_idx)
            elif upload != "dense":
                restore_planes(packed[0], dargs,
                               **{upload + "_ks": packed[1]})
            ev[1].record()
            torch.cuda.synchronize()
            rows.append(dict(
                host_decode_ms=(t1 - t0) * 1e3, pack_ms=(t2 - t1) * 1e3,
                upload_ms=(t3 - t2) * 1e3,
                restore_ms=ev[0].elapsed_time(ev[1]),
                wire_bytes=int(sum(a.nbytes for a in args))))
        rows = rows[1:]
        med = {k: sorted(r[k] for r in rows)[len(rows) // 2]
               for k in rows[0]}
        e2e = wall(lambda: p(bufs), 3)
        p.close()
        return dict(**med, e2e_ms_per_batch=e2e,
                    e2e_mpix_s=mpix / e2e * 1e3)

    timing = {u: stages(u) for u in ("scan",) + UPLOADS}
    phase("timing_uploads", card=card, images=N_IMG, mpix_per_batch=mpix,
          fused=True, note="scan: host_decode_ms is the header parse, "
          "pack_ms the scan wire, restore_ms K1 + split on the card; the "
          "others: the host C++ decode on 8 threads, the wire pack, the "
          "restore kernel's launches (none for dense)", **timing)
    pool.shutdown()
    return slice_launches


F5_N = 4                   # images per configuration of phase 22
F5_VIT = (("tokens_289", dict(image_size=272)),
          ("head_128", dict(dim=768, heads=6)),
          ("head_256", dict(dim=768, heads=3)),
          ("head_192", dict(dim=384, heads=2)),
          ("vit_h14_widths", dict(dim=1280, heads=16, patch=14)),
          ("odd_width_head_43", dict(dim=387, heads=9)),
          ("experts_128", dict(moe_experts=128, moe_every=1)))
F5_RESNET = dict(stem_channels=33, stage_channels=(33, 65),
                 blocks_per_stage=1)
F5_ATTENTION = (16, 576, 6, 128)   # phase 23's (N, S, H, D)
F5_WIDE = ((4, 196, 3, 256), (4, 196, 2, 192))   # the wide kernels' shapes


def _ulp(v):
    """One bf16 ulp at |v| (8 significant bits), elementwise."""
    import torch

    m = v.abs().double().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _nbytes(*ts):
    import torch

    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _first_args(fn, mods_names):
    """Run fn with each (module, name) wrapper recording the detached
    arguments of its first call: {name: args}."""
    import contextlib
    from unittest import mock

    import torch

    got = {}

    def rec(name, real):
        def call(*a):
            got.setdefault(name, tuple(
                x.detach() if isinstance(x, torch.Tensor) else x for x in a))
            return real(*a)
        return call

    with contextlib.ExitStack() as stack:
        for mod, name in mods_names:
            stack.enter_context(mock.patch.object(
                mod, name, rec(name, getattr(mod, name))))
        fn()
    return got


def _bucket(results, timed, kernel, label, args, kfn, pfn, nbytes):
    """Time a kernel and its plain version on one call's arguments; append
    the row to the kernel's buckets (the attention's bound also counts its
    bf16 products: 2 of 2 n h s^2 d FLOPs forward, 5 backward)."""
    got, want = kfn(*args), pfn(*args)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in pairs if a.numel())
    flops = 0
    if kernel in ("vit_attention", "vit_attention_bwd"):
        n, s, _, h, d = args[0].shape
        flops = (4 if kernel == "vit_attention" else 10) * n * h * s * s * d
    row = dict(bucket=label, max_abs_err=err,
               ms=timed(lambda: kfn(*args), 5),
               plain_ms=timed(lambda: pfn(*args), 2, warm=0),
               library_ms=None, **bound(nbytes, bf16_flops=flops))
    results[kernel].setdefault("buckets", []).append(row)
    return row


def vit_kernel_names():
    """The ViT's kernel wrappers: (forward wrappers in models.vit: {name:
    (kernel, plain)}, backward wrappers: {name: (module, kernel, plain)},
    [(module, name, plain)] that turn a step's kernel calls into the
    plain versions, the autograd Functions staying)."""
    from picha_tpu_torch.ops import attention as att_mod
    from picha_tpu_torch.ops import layernorm as ln_mod
    from picha_tpu_torch.ops import moe as moe_mod

    fwd = {"layer_norm": ("vit_layernorm", ln_mod.layer_norm_plain),
           "attention": ("vit_attention", att_mod.attention_plain),
           "route_dispatch": ("moe_route_dispatch",
                              moe_mod.route_dispatch_plain),
           "combine": ("moe_combine", moe_mod.combine_plain)}
    bwd = {"layer_norm_backward": (ln_mod, "vit_layernorm_bwd",
                                   ln_mod.layer_norm_backward_plain),
           "attention_backward": (att_mod, "vit_attention_bwd",
                                  att_mod.attention_backward_plain),
           "dispatch_backward": (moe_mod, "moe_dispatch_bwd",
                                 moe_mod.dispatch_backward_plain),
           "combine_backward": (moe_mod, "moe_combine_bwd",
                                moe_mod.combine_backward_plain)}
    plain_ops = [
        (ln_mod, "layer_norm_k17", ln_mod.layer_norm_plain),
        (ln_mod, "layer_norm_backward", ln_mod.layer_norm_backward_plain),
        (att_mod, "attention_k18", att_mod.attention_plain),
        (att_mod, "attention_backward", att_mod.attention_backward_plain),
        (moe_mod, "combine_k20", moe_mod.combine_plain),
        (moe_mod, "dispatch_backward", moe_mod.dispatch_backward_plain),
        (moe_mod, "combine_backward", moe_mod.combine_backward_plain)]
    return fwd, bwd, plain_ops


def vit_config_checks(dev, results, timed, configs, n, depth, gen, prefix):
    """Each ViT configuration (label, ViTConfig keywords) at `depth` on `n`
    random images from `gen`: the forward's launches, logits within 0.03 +
    1 bf16 ulp of the plain path (the MoE's on the kernel path's routes),
    every gradient leaf within 2e-2 relative L2 of the plain path's, one
    train step, and each kernel timed on the arguments of its first call
    (a row of its `buckets`, labelled `prefix label`). Returns {label:
    its numbers}."""
    import contextlib
    from unittest import mock

    import torch

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.models import vit as vit_mod
    from picha_tpu_torch.models.vit import ViT, ViTConfig, make_train_step
    from picha_tpu_torch.ops import attention as att_mod
    from picha_tpu_torch.ops import layernorm as ln_mod
    from picha_tpu_torch.ops import moe as moe_mod
    from picha_tpu_torch.ops.jpeg import full_precision
    from picha_tpu_torch.optim import tree_leaves, tree_unflatten

    fwd_wrappers, bwd_wrappers, plain_ops = vit_kernel_names()
    out = {}
    for label, kw in configs:
        cfg = ViTConfig(depth=depth, **kw)
        model = ViT(cfg, seed=0, device=dev)
        params = model.params()
        images = torch.rand((n, cfg.image_size, cfg.image_size, 3),
                            generator=gen).to(dev)
        labels = torch.randint(0, 1000, (n,), generator=gen).to(dev)
        routes = []
        real_rd = vit_mod.route_dispatch

        def recorded_rd(*a):
            o = real_rd(*a)
            routes.append((o[1], o[2]))
            return o

        reset_launch_counts()
        with mock.patch.object(vit_mod, "route_dispatch", recorded_rd):
            logits = model(images)
        torch.cuda.synchronize()
        fwd_launches = {k: v for k, v in launch_counts().items() if v}
        want = {"vit_layernorm": 2 * cfg.depth + 1,
                "vit_attention": cfg.depth}
        if cfg.moe_experts:
            n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.depth))
            want.update(moe_route_dispatch=n_moe, moe_combine=n_moe)
        if fwd_launches != want:
            raise AssertionError(f"{prefix} {label}: forward launches "
                                 f"{fwd_launches}, want {want}")
        plains = {k: p for k, (_n, p) in fwd_wrappers.items()}
        if cfg.moe_experts:
            plains["route_dispatch"] = pinned_route_dispatch(list(routes))
        with mock.patch.multiple(vit_mod, **plains):
            logits_p = model(images)
        diff = (logits - logits_p).abs()
        lim = VIT_LOGIT_TOL + _ulp(torch.maximum(logits.abs(),
                                                 logits_p.abs()))
        if not bool(torch.isfinite(logits).all()) or \
                bool((diff > lim).any()):
            raise AssertionError(f"{prefix} {label}: logits "
                                 f"{float(diff.max())} from the plain path")

        def grads(record=None, pinned=None):
            leaves = [p.detach().requires_grad_()
                      for p in tree_leaves(params)]
            with contextlib.ExitStack() as stack, full_precision():
                if pinned is not None:
                    stack.enter_context(mock.patch.object(
                        moe_mod, "route_dispatch_k19", pinned))
                    stack.enter_context(mock.patch.object(
                        moe_mod, "dispatch_backward",
                        pinned_dispatch_backward))
                loss = vit_mod.loss_fn(tree_unflatten(params, leaves),
                                       images, labels, cfg)
                g = torch.autograd.grad(loss, leaves)
            return loss.detach(), g

        reset_launch_counts()
        routes.clear()
        with mock.patch.object(vit_mod, "route_dispatch", recorded_rd):
            loss_k, g_k = grads()
        torch.cuda.synchronize()
        step_launches = {k: v for k, v in launch_counts().items() if v}
        with contextlib.ExitStack() as stack:
            for mod, name, fn in plain_ops:
                stack.enter_context(mock.patch.object(mod, name, fn))
            loss_p, g_p = grads(pinned=pinned_route_dispatch(list(routes))
                                if cfg.moe_experts else
                                moe_mod.route_dispatch_plain)
        rl2 = [_rel_l2(a, b) for a, b in zip(g_k, g_p)]
        names = [nm for nm, _ in _leaf_names(params)]
        if max(rl2) > GRAD_RL2:
            worst = names[rl2.index(max(rl2))]
            raise AssertionError(f"{prefix} {label}: gradient leaf {worst} "
                                 f"{max(rl2)} from the plain path")
        init_opt, step = make_train_step(cfg, TRAIN_LR, dev)
        _p, state, loss1 = step(params, init_opt(params), images, labels)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(loss1)) or int(state.count) != 1:
            raise AssertionError(f"{prefix} {label}: train step loss {loss1}")
        # each kernel's time at this configuration's shapes (the arguments
        # of its first call)
        fa = _first_args(lambda: model(images),
                         [(vit_mod, k) for k in fwd_wrappers])
        ba = _first_args(grads, [(mod, k) for k, (mod, _n, _p)
                                 in bwd_wrappers.items()])
        rows = {}
        for k, (kernel, pfn) in fwd_wrappers.items():
            if k in fa:
                a = fa[k]
                kfn = {"layer_norm": ln_mod.layer_norm_k17,
                       "attention": att_mod.attention_k18,
                       "route_dispatch": moe_mod.route_dispatch_k19,
                       "combine": moe_mod.combine_k20}[k]
                o = kfn(*a)
                rows[kernel] = _bucket(
                    results, timed, kernel, f"{prefix} {label}", a, kfn, pfn,
                    _nbytes(*a) + _nbytes(*(o if isinstance(o, tuple)
                                            else (o,))))
        for k, (mod, kernel, pfn) in bwd_wrappers.items():
            if k in ba:
                a = ba[k]
                kfn = getattr(mod, k)
                o = kfn(*a)
                rows[kernel] = _bucket(
                    results, timed, kernel, f"{prefix} {label}", a, kfn, pfn,
                    _nbytes(*a) + _nbytes(*(o if isinstance(o, tuple)
                                            else (o,))))
        s, d = cfg.seq_len, cfg.head_dim
        out[label] = dict(
            config=dict(kw, depth=cfg.depth), tokens=s, head_dim=d,
            images=n, forward_launches=fwd_launches,
            step_launches=step_launches,
            logits_max_abs_vs_plain=float(diff.max()),
            loss=float(loss_k), loss_plain=float(loss_p),
            max_rel_l2=max(rl2), max_rel_l2_leaf=names[rl2.index(max(rl2))],
            attention_tiled=dict(forward=att_mod.tiled(s, d),
                                 backward=att_mod.tiled(s, d, True)),
            layernorm_tuned=ln_mod.tuned(cfg.dim),
            moe_tuned=(moe_mod.tuned(cfg.moe_experts, cfg.dim)
                       if cfg.moe_experts else None),
            forward_ms=timed(lambda: model(images), 3),
            kernel_ms={k: r["ms"] for k, r in rows.items()})
        del model, params, g_k, g_p, logits, logits_p
    return out


def f5_phases(dev, card, results, phase, timed):
    """Phases 22-23: the model configurations past the tuned kernels'
    envelopes (F5; see the module doc). Adds each kernel's times at these
    shapes to its `buckets` in results."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.models import resnet as rn
    from picha_tpu_torch.ops import attention as att_mod
    from picha_tpu_torch.ops import instance_norm as inm
    from picha_tpu_torch.optim import tree_leaves, tree_unflatten

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(11)

    # 22. each ViT configuration: forward and one train step, depth 2
    out = vit_config_checks(dev, results, timed, F5_VIT, F5_N, 2, gen, "F5")

    # the ResNet with odd channel counts
    cfg = rn.ResNetConfig(**F5_RESNET)
    model = rn.ResNet(cfg, seed=0, device=dev)
    params = model.params()
    images = torch.rand((F5_N, cfg.image_size, cfg.image_size, 3),
                        generator=gen).to(dev)
    labels = torch.randint(0, 1000, (F5_N,), generator=gen).to(dev)
    n_norms = 2 * len(cfg.stage_channels) * cfg.blocks_per_stage

    @contextlib.contextmanager
    def rn_plain():
        with mock.patch.object(inm, "norm_relu_k25", inm.norm_relu_plain), \
                mock.patch.object(inm, "norm_relu_backward",
                                  inm.norm_relu_backward_plain):
            yield

    def rn_grads(p64=False):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        if p64:
            leaves = [p.detach().double().requires_grad_()
                      for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        with rn.conv_pin():
            if p64:
                lg = resnet_forward64(tree, images.double())
                loss = -torch.log_softmax(lg, -1).gather(
                    -1, labels.long()[:, None]).mean()
            else:
                lg = None
                loss = rn.loss_fn(tree, images, labels, cfg)
            g = torch.autograd.grad(loss, leaves)
        return loss.detach(), g, lg

    reset_launch_counts()
    logits = model(images)
    loss_k, g_k, _ = rn_grads()
    torch.cuda.synchronize()
    rn_launches = {k: v for k, v in launch_counts().items() if v}
    if rn_launches != {"resnet_norm": 2 * n_norms,
                       "resnet_norm_bwd": n_norms}:
        raise AssertionError(f"F5 ResNet launches {rn_launches}")
    with rn_plain():
        logits_p = model(images)
        loss_p, g_p, _ = rn_grads()
    _l64, g64, logits64 = rn_grads(p64=True)
    lmax = float((logits - logits_p).abs().max())
    ratios = [float64_ratio(a, b, c) for a, b, c in zip(g_k, g_p, g64)]
    lok, lratio = float64_ratio(logits, logits_p, logits64.detach())
    names = [n for n, _ in _leaf_names(params)]
    bad = [n for n, (ok, _r) in zip(names, ratios) if not ok]
    if lmax > RESNET_LOGIT_TOL or not lok or bad:
        raise AssertionError(f"F5 ResNet: logits {lmax} ({lratio}), leaves "
                             f"past the float64 criterion {bad}")
    init_opt, step = rn.make_train_step(cfg, TRAIN_LR, dev)
    _p, state, loss1 = step(params, init_opt(params), images, labels)
    if not bool(torch.isfinite(loss1)):
        raise AssertionError(f"F5 ResNet step loss {loss1}")
    ka = _first_args(lambda: rn_grads(), [(inm, "norm_relu_k25"),
                                         (inm, "norm_relu_backward")])
    x25, s25 = ka["norm_relu_k25"]
    r25 = _bucket(results, timed, "resnet_norm", "F5 ResNet odd channels",
                  (x25, s25), inm.norm_relu_k25, inm.norm_relu_plain,
                  _nbytes(x25) * 2)
    a26 = ka["norm_relu_backward"]
    r26 = _bucket(results, timed, "resnet_norm_bwd", "F5 ResNet odd channels",
                  a26, inm.norm_relu_backward, inm.norm_relu_backward_plain,
                  _nbytes(*a26[:3]) * 4 // 3)
    out["resnet_odd_channels"] = dict(
        config=F5_RESNET, images=F5_N, launches=rn_launches,
        logits_max_abs_vs_plain=lmax, logits_float64_ratio=lratio,
        max_float64_ratio=max(r for _ok, r in ratios),
        loss=float(loss_k), loss_plain=float(loss_p),
        k25_shape=list(x25.shape), k25_ms=r25["ms"], k26_ms=r26["ms"])
    phase("f5_models", card=card, **out,
          note="forward and one train step of each configuration on the "
               "card (depth 2, 4 random images): logits within 0.03 + 1 "
               "bf16 ulp of the plain path (the MoE's on the kernel path's "
               "routes), each ViT gradient leaf within 2e-2 relative L2 of "
               "the plain path's, the ResNet's by the float64 criterion")

    # 23. K18 and K22 at S = 576, D = 128 beside SDPA
    n, s, h, d = F5_ATTENTION
    g2 = torch.Generator().manual_seed(12)
    qkv = (2.0 * torch.randn((n, s, 3, h, d), generator=g2)).to(bf16).to(dev)
    do = torch.randn((n, s, h * d), generator=g2).to(bf16).to(dev)
    scale = d ** -0.5
    o = att_mod.attention_k18(qkv, scale)
    want = att_mod.attention_plain(qkv, scale)
    row = want.view(n, s, h, d).abs().amax(-1, keepdim=True).expand(
        n, s, h, d).reshape(n, s, h * d)
    dd = (o.double() - want.double()).abs()
    over18 = float((dd - _ulp(torch.maximum(o.abs(), want.abs()))
                    - _ulp(row)).max())
    dq = att_mod.attention_backward(qkv, do, scale)
    wq = att_mod.attention_backward_plain(qkv, do, scale)
    blk = wq.abs().amax(dim=(1, 4), keepdim=True)
    over22 = float(((dq.double() - wq.double()).abs()
                    - _ulp(torch.maximum(dq.abs(), wq.abs())) - _ulp(blk))
                   .max())
    del want, wq, row, dd, blk
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    gout = do.view(n, s, h, d).transpose(1, 2)

    def sdpa_fb():
        y = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        torch.autograd.grad(y, (qg, kg, vg), gout)

    fl = 4 * n * h * s * s * d
    k18 = dict(ms=timed(lambda: att_mod.attention_k18(qkv, scale), 10),
               sdpa_ms=timed(lambda: F.scaled_dot_product_attention(
                   q, k, v, scale=scale), 10),
               over_bound=over18,
               build=att_mod.kernel_info(s, d),
               **bound(qkv.numel() * 2 + o.numel() * 2, bf16_flops=fl))
    k22 = dict(ms=timed(lambda: att_mod.attention_backward(qkv, do, scale),
                        5),
               sdpa_forward_backward_ms=timed(sdpa_fb, 5),
               sdpa_backward_ms=timed(lambda: torch.autograd.grad(
                   og, (qg, kg, vg), gout, retain_graph=True), 5),
               over_bound=over22,
               build=att_mod.kernel_info(s, d, backward=True),
               **bound(qkv.numel() * 4 + do.numel() * 2,
                       bf16_flops=int(2.5 * fl)))
    k22.update(dp_scratch_traffic(n, s, h, timed))
    k18["sdpa_kernels"] = attention_library(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    k22["sdpa_backward_kernels"] = attention_library(
        lambda: torch.autograd.grad(og, (qg, kg, vg), gout,
                                    retain_graph=True))
    for key, r in (("vit_attention", k18), ("vit_attention_bwd", k22)):
        results[key].setdefault("buckets", []).append(dict(
            bucket=f"tiled, S = {s}, D = {d}, N = {n}, H = {h}",
            max_abs_err=None, ms=r["ms"], plain_ms=None,
            library_ms=r.get("sdpa_ms", r.get("sdpa_backward_ms")),
            bound_ms=r["bound_ms"], bound_by=r["bound_by"]))
    if over18 > 0 or over22 > 0:
        raise AssertionError(f"K18 / K22 at S = {s}, D = {d}: past their "
                             f"bounds by {over18} / {over22}")
    # the wide kernels (heads past 128) beside SDPA at their shapes
    wide = {}
    for (wn, ws, wh, wd) in F5_WIDE:
        wqkv = torch.randn((wn, ws, 3, wh, wd), generator=g2).to(bf16).to(dev)
        wdo = torch.randn((wn, ws, wh * wd), generator=g2).to(bf16).to(dev)
        wsc = wd ** -0.5
        q, k, v = (wqkv[:, :, i].transpose(1, 2) for i in range(3))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        og = F.scaled_dot_product_attention(qg, kg, vg, scale=wsc)
        gout = wdo.view(wn, ws, wh, wd).transpose(1, 2)
        wfl = 4 * wn * wh * ws * ws * wd
        wide[f"head_{wd}"] = dict(
            shape=[wn, ws, wh, wd],
            k18_ms=timed(lambda: att_mod.attention_k18(wqkv, wsc), 10),
            k22_ms=timed(lambda: att_mod.attention_backward(wqkv, wdo, wsc),
                         5),
            sdpa_ms=timed(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=wsc), 10),
            sdpa_backward_ms=timed(lambda: torch.autograd.grad(
                og, (qg, kg, vg), gout, retain_graph=True), 5),
            sdpa_kernels=attention_library(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=wsc)),
            sdpa_backward_kernels=attention_library(
                lambda: torch.autograd.grad(og, (qg, kg, vg), gout,
                                            retain_graph=True)),
            k18_bound=bound(_nbytes(wqkv) * 4 // 3, bf16_flops=wfl),
            k22_bound=bound(_nbytes(wqkv) * 2 + _nbytes(wdo),
                            bf16_flops=int(2.5 * wfl)))
    phase("f5_attention", card=card, shape=[n, s, h, d], K18=k18, K22=k22,
          wide=wide,
          note="the tiled builds; K18 within 1 bf16 ulp + 1 ulp of the "
               "row's largest |o| of its plain version, K22 within 1 ulp "
               "+ 1 ulp of its head block's largest |value|; "
               "dp_scratch_copy_ms: a copy of as many bytes as K22's dP "
               "scratch, which it writes once and reads back; *_kernels: "
               "the CUDA kernels "
               "SDPA launched (its backend); wide: the wide kernels (heads "
               "past 128) beside SDPA at their shapes")


VIT384 = dict(image_size=384)  # ViT-S/16's widths at 384^2: 576 tokens
VIT384_N = 128                 # images of phase 30's timing
VIT384_PARITY_N = 8            # images of phase 29's parity run


def attention_library(fn):
    """The CUDA kernels one call of fn launches (torch.profiler), to name
    the SDPA backend that ran; "not measured" where the profiler records
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type.name == "CUDA"})
    except Exception as exc:     # the profiler is the card machine's
        return f"not measured ({type(exc).__name__}: {exc})"
    return names or "not measured"


def device_ms_by_kernel(fn, reps=10):
    """Device ms and launches a call of fn, by kernel name (torch.profiler;
    memsets under their own name), and their sum; "not measured" where
    the profiler records no device time."""
    import re

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
    if not rows:
        return "not measured"
    rows["sum_ms"] = sum(v["ms"] for v in rows.values())
    return rows


def dp_scratch_traffic(n, s, h, timed):
    """The tiled K22's dP scratch at (n, s, h): its bytes, and the CUDA-event
    ms of a copy of as many bytes (one write and one read of them, the
    least its traffic costs)."""
    import torch

    sp = (s + 63) // 64 * 64
    a = torch.empty(n * h * sp * sp, dtype=torch.bfloat16, device="cuda")
    b = torch.empty_like(a)
    return dict(dp_scratch_bytes=a.numel() * 2,
                dp_scratch_copy_ms=timed(lambda: b.copy_(a), 5))


def vit384_phases(dev, card, results, phase, timed):
    """Phases 29-30: ViTConfig(image_size=384) at full width and depth on
    the card (see the module doc). Adds the tiled K18's and K22's rows at
    its shapes to their `buckets`; returns their launches a forward and a
    step."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.models import vit as vit_mod
    from picha_tpu_torch.models.vit import ViT, ViTConfig, make_train_step
    from picha_tpu_torch.ops import attention as att_mod
    from picha_tpu_torch.ops import layernorm as ln_mod

    gen = torch.Generator().manual_seed(13)
    cfg = ViTConfig(**VIT384)
    s, h, d = cfg.seq_len, cfg.heads, cfg.head_dim
    if not (att_mod.tiled(s, d) and att_mod.tiled(s, d, backward=True)):
        raise AssertionError(f"ViT-S/384: ({s}, {d}) does not take the "
                             "tiled K18 / K22")

    # 29. parity at full depth: the forward and the gradients against the
    # plain path, one train step
    par = vit_config_checks(dev, results, timed, (("vit_s384", VIT384),),
                            VIT384_PARITY_N, cfg.depth, gen, "ViT-S/384")
    phase("vit_s384", card=card, **par["vit_s384"],
          limit_logits=f"{VIT_LOGIT_TOL} + 1 bf16 ulp", limit_rel_l2=GRAD_RL2,
          note="ViTConfig(image_size=384) (ViT-S/16's widths at 384^2, 576 "
               "tokens, mean-pooled) at full depth on 8 random images: "
               "logits and every gradient leaf against the same forward and "
               "step through the plain versions, one train step")

    # 30. full width at N = 128: launches (no plain version, no SDPA),
    # forward and step times, K18 / K22 x 12, peak memory
    model = ViT(cfg, seed=0, device=dev)
    params = model.params()
    images = torch.rand((VIT384_N, cfg.image_size, cfg.image_size, 3),
                        generator=gen).to(dev)
    labels = torch.randint(0, cfg.classes, (VIT384_N,),
                           generator=gen).to(dev)
    init_opt, step = make_train_step(cfg, TRAIN_LR, dev)
    box = [params, init_opt(params)]

    def one(mark=None):
        box[0], box[1], loss = step(box[0], box[1], images, labels,
                                    mark=mark)
        return loss

    def refuse(name):
        def call(*_a, **_k):
            raise AssertionError(f"ViT-S/384 called {name}")
        return call

    plain_names = [(att_mod, "attention_plain"),
                   (att_mod, "attention_backward_plain"),
                   (ln_mod, "layer_norm_plain"),
                   (ln_mod, "layer_norm_backward_plain"),
                   (F, "scaled_dot_product_attention")]
    with contextlib.ExitStack() as stack:
        for mod, name in plain_names:
            stack.enter_context(mock.patch.object(mod, name, refuse(name)))
        reset_launch_counts()
        logits = model(images)
        torch.cuda.synchronize()
        fwd = only(launch_counts(), {"vit_layernorm": 2 * cfg.depth + 1,
                                     "vit_attention": cfg.depth},
                   "ViT-S/384 forward")
        reset_launch_counts()
        loss = one()
        torch.cuda.synchronize()
        stp = only(launch_counts(), {
            "vit_layernorm": 2 * cfg.depth + 1, "vit_attention": cfg.depth,
            "vit_layernorm_bwd": 2 * cfg.depth + 1,
            "vit_attention_bwd": cfg.depth}, "ViT-S/384 step")
    if tuple(logits.shape) != (VIT384_N, cfg.classes) or \
            not bool(torch.isfinite(logits).all()) or \
            not bool(torch.isfinite(loss)):
        raise AssertionError(f"ViT-S/384: logits {tuple(logits.shape)}, "
                             f"loss {float(loss)}")
    fwd_ms = median_ms(lambda: model(images), 5)
    step_ms = median_ms(one, 5)
    # K18 x 12 through the forward's mark hook; K22 x 12 by events around
    # its calls inside a step
    k18x = []
    for _ in range(3):
        m = Marks()
        model(images, m)
        k18x.append(m.ms()["K18"])
    real_bwd = att_mod.attention_backward
    k22_events = []

    def evented(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_bwd(*a, **k)
        ev[1].record()
        k22_events.append(ev)
        return out

    k22x = []
    for _ in range(3):
        k22_events.clear()
        with mock.patch.object(att_mod, "attention_backward", evented):
            one()
        torch.cuda.synchronize()
        k22x.append(sum(a.elapsed_time(b) for a, b in k22_events))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    fl = 4 * VIT384_N * h * s * s * d            # K18's bf16 product FLOPs
    phase("timing_vit_s384", card=card, images=VIT384_N, tokens=s,
          forward_launches=fwd, step_launches=stp,
          forward_ms=fwd_ms, forward_images_per_s=VIT384_N / fwd_ms * 1e3,
          step_ms=step_ms, step_images_per_s=VIT384_N / step_ms * 1e3,
          k18_x12_ms=sorted(k18x)[1], k22_x12_ms=sorted(k22x)[1],
          peak_device_bytes=peak, peak_above_resident_bytes=peak - base,
          note="forward_ms, step_ms: medians of 5 CUDA-event timings of "
               "ViT(cfg)(images) and make_train_step's step; k18_x12_ms: "
               "the forward's K18 stage (mark hook), k22_x12_ms: CUDA "
               "events around the step's 12 K22 calls, medians of 3; the "
               "plain versions and F.scaled_dot_product_attention patched "
               "to raise during the counted forward and step")

    # one launch of each at the step's shapes beside SDPA and the bounds
    fa = _first_args(lambda: model(images), [(vit_mod, "attention")])
    ba = _first_args(one, [(att_mod, "attention_backward")])
    qkv, scale = fa["attention"]
    qkv_b, do, _sc = ba["attention_backward"]
    o = att_mod.attention_k18(qkv, scale)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    k18 = dict(ms=timed(lambda: att_mod.attention_k18(qkv, scale), 10),
               library_ms=timed(lambda: F.scaled_dot_product_attention(
                   q, k, v, scale=scale), 10),
               build=att_mod.kernel_info(s, d),
               **bound(_nbytes(qkv, o), bf16_flops=fl))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in
                  (qkv_b[:, :, i].transpose(1, 2) for i in range(3)))
    og = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    gout = do.view(VIT384_N, s, h, d).transpose(1, 2)
    dqkv = att_mod.attention_backward(qkv_b, do, scale)
    k22 = dict(ms=timed(lambda: att_mod.attention_backward(qkv_b, do, scale),
                        5),
               library_ms=timed(lambda: torch.autograd.grad(
                   og, (qg, kg, vg), gout, retain_graph=True), 5),
               build=att_mod.kernel_info(s, d, backward=True),
               **dp_scratch_traffic(VIT384_N, s, h, timed),
               **bound(_nbytes(qkv_b, do, dqkv), bf16_flops=int(2.5 * fl)))
    for key, r, args in (("vit_attention", k18, qkv),
                         ("vit_attention_bwd", k22, qkv_b)):
        results[key].setdefault("buckets", []).append(dict(
            bucket=f"ViT-S/384 step, {tuple(args.shape)}", max_abs_err=None,
            ms=r["ms"], plain_ms=None, library_ms=r["library_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"]))
    phase("vit_s384_attention", card=card, shape=list(qkv.shape), K18=k18,
          K22=k22, note="one launch each on the step's first call's "
                        "arguments; library_ms: F.scaled_dot_product_"
                        "attention (K22: its backward alone); "
                        "dp_scratch_copy_ms: a copy of as many bytes as "
                        "K22's dP scratch, which it writes once and reads "
                        "back")
    return {"vit_attention": fwd["vit_attention"],
            "vit_attention_bwd": stp["vit_attention_bwd"]}


def raw420_phases(dev, card, results, phase, timed, wall, corpus, strict,
                  device_jpegs):
    """Phases 24-28: row 8b, encode_backend="raw420" (K31 + the host C++
    writer) and "tpu" (K2 + the host C++ writer) on the slice's batch
    (see the module doc). `device_jpegs`: {fused: encode_backend="device"
    outputs of the restart corpus in this run}. Fills results for K31;
    returns its launches in the fused restart raw420 slice."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    import numpy as np
    import torch

    from picha_tpu_torch.kernels import launch_counts, reset_launch_counts
    from picha_tpu_torch.ops import jpeg_write as jw
    from picha_tpu_torch.ops.jpeg import (quality_tables, yuv420_pack,
                                          yuv420_pack_plain)
    from picha_tpu_torch.ops.jpeg_huffman_decode import scan_wire
    from picha_tpu_torch.pipeline import JpegBatchPipeline
    from picha_tpu_torch.pipeline import jpeg_batch as jb

    mpix = N_IMG * SRC_W * SRC_H / 1e6
    kw = dict(width=OUT_W, height=OUT_H, encode_quality=QUALITY,
              upload="scan", num_threads=8, device=dev)
    ql, qc = quality_tables(QUALITY)
    head = jw.libjpeg_header(OUT_W, OUT_H, jw.resized_comp_sig(OUT_H, OUT_W, 3),
                             (ql, qc, qc))

    def scan_of(b):
        return bytes(b)[bytes(b).index(b"\xff\xda"):]

    def recorded(fn, store):
        def call(*a):
            store.append(a[0].detach().clone())
            return fn(*a)
        return call

    # 24. K31 against its plain version on the slice's pixels
    k31 = {}
    planes = {}
    for fused in (True, False):
        px = []
        p = JpegBatchPipeline(fused=fused, encode_backend="raw420", **kw)
        with mock.patch.object(jb, "yuv420_pack", recorded(yuv420_pack, px)):
            p(corpus)
        p.close()
        x = px[0]
        got = yuv420_pack(x)
        want = yuv420_pack_plain(x)
        if not torch.equal(got, want):
            raise AssertionError(f"K31 (fused={fused}) differs from its "
                                 f"plain version")
        planes[fused] = got.cpu().numpy()
        k31[fused] = dict(
            input=list(x.shape), dtype=str(x.dtype), out=list(got.shape),
            max_abs_err=0.0, ms=timed(lambda: yuv420_pack(x), 20),
            plain_ms=timed(lambda: yuv420_pack_plain(x), 3),
            library_ms=None,
            **bound(x.numel() * x.element_size() + got.numel()))
        del px, x, got, want
    results["yuv420_pack"] = dict(k31[True])
    results["yuv420_pack"]["buckets"] = [dict(bucket="staged pixels",
                                              **k31[False])]
    phase("K31", card=card, equal=True, fused=k31[True], staged=k31[False],
          library="none: no one PyTorch call computes the 4:2:0 pack")

    # 25. the host C++ writer against the numpy writer and libjpeg's bytes
    buf = planes[True]
    p_tpu = JpegBatchPipeline(fused=True, encode_backend="tpu", **kw)
    infos = p_tpu.entropy_decode(corpus)
    sig = jb.signature(infos[0])
    ks, wire = scan_wire(infos)
    wire_dev = torch.from_numpy(wire).to(dev)
    coefs, _ok = p_tpu.run_bucket(sig, wire_dev, ks)
    coefs = [c.cpu().numpy() for c in coefs]
    for i in range(2):
        y, cb, cr = jw.split_yuv420(buf[i], OUT_W, OUT_H)
        if jw.write_raw420(y, cb, cr, OUT_W, OUT_H, QUALITY, native=True) \
                != jw.write_raw420(y, cb, cr, OUT_W, OUT_H, QUALITY):
            raise AssertionError(f"C++ raw420 writer differs from numpy on "
                                 f"image {i}")
        cs = [c[i] for c in coefs]
        if jw.write_coefficients(cs, OUT_W, OUT_H, QUALITY, native=True) \
                != jw.write_coefficients(cs, OUT_W, OUT_H, QUALITY):
            raise AssertionError(f"C++ coefficient writer differs from "
                                 f"numpy on image {i}")
    sys.path.insert(0, str(FIXTURES))
    import make_fixtures as mf

    with np.load(FIXTURES / "raw420_inputs.npz") as z:
        arrays = {k: z[k] for k in z.files}
    for name, (kind, (h, w), q) in mf.HOST_WRITER_CASES.items():
        a = {k.split(".", 1)[1]: v for k, v in arrays.items()
             if k.startswith(name + ".")}
        got = (jw.write_raw420(a["y"], a["cb"], a["cr"], w, h, q, native=True)
               if kind == "raw420" else jw.write_coefficients(
                   [a[f"c{i}"] for i in range(len(a))], w, h, q,
                   native=True))
        if got != (FIXTURES / f"raw420_{name}.jpg").read_bytes():
            raise AssertionError(f"C++ writer differs from libjpeg's bytes "
                                 f"on {name}")
    pool = ThreadPoolExecutor(max_workers=8)
    split = [jw.split_yuv420(buf[i], OUT_W, OUT_H) for i in range(N_IMG)]
    one = split[0]
    t = time.perf_counter()
    jw.write_raw420(*one, OUT_W, OUT_H, QUALITY)
    plain_raw_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    jw.write_coefficients([c[0] for c in coefs], OUT_W, OUT_H, QUALITY)
    plain_coef_ms = (time.perf_counter() - t) * 1e3
    writer = dict(
        raw420_one_image_one_thread_ms=wall(lambda: jw.write_raw420(
            *one, OUT_W, OUT_H, QUALITY, native=True), 9),
        raw420_batch_8_threads_ms=wall(lambda: list(pool.map(
            lambda pl: jw.write_raw420(*pl, OUT_W, OUT_H, QUALITY,
                                       native=True), split)), 5),
        coefficients_one_image_one_thread_ms=wall(
            lambda: jw.write_coefficients([c[0] for c in coefs], OUT_W,
                                          OUT_H, QUALITY, native=True), 9),
        coefficients_batch_8_threads_ms=wall(lambda: list(pool.map(
            lambda i: jw.write_coefficients([c[i] for c in coefs], OUT_W,
                                            OUT_H, QUALITY, native=True),
            range(N_IMG))), 5),
        raw420_plain_ms_per_image=plain_raw_ms,
        coefficients_plain_ms_per_image=plain_coef_ms)
    pool.shutdown()
    phase("host_writer", card=card, equal_to_numpy_images=2,
          equal_to_libjpeg_fixtures=sorted(mf.HOST_WRITER_CASES), **writer)

    # 26. the full batch through both backends, fused and staged
    out = {}
    raw = {}
    k31_launches = {}
    for backend in ("raw420", "tpu"):
        for fused in (True, False):
            p = JpegBatchPipeline(fused=fused, encode_backend=backend, **kw)
            reset_launch_counts()
            jpegs = p(corpus)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            want_k = (("yuv420_pack",) if backend == "raw420"
                      else ("jpeg_encode_front",)) + (
                ("huffman_decode_restart",) if fused else
                ("huffman_decode_restart", "idct_plane", "upsample_color",
                 "resize_2d"))
            gone = ("huffman_encode_scan",) + (
                ("jpeg_encode_front",) if backend == "raw420"
                else ("yuv420_pack",))
            if any(k not in counts for k in want_k) or any(
                    k in counts for k in gone):
                raise AssertionError(f"{backend} fused={fused}: launches "
                                     f"{counts}")
            if p.scan_fallbacks or p.overflow_fallbacks:
                raise AssertionError(f"{backend} fused={fused}: fallbacks")
            lsb = mean_abs(jpegs, strict)
            if max(lsb) > PARITY_LSB:
                raise AssertionError(f"{backend} fused={fused}: {max(lsb)} "
                                     f"LSB from strict")
            row = dict(launches=counts, lsb_vs_strict_mean=sum(lsb) / N_IMG,
                       lsb_vs_strict_max=max(lsb),
                       bytes=[len(j) for j in jpegs])
            if backend == "tpu":
                # K2's coefficients coded by the host writer: the device
                # encode's scan bytes behind libjpeg's header
                same = sum(bytes(j).startswith(head)
                           and scan_of(j) == scan_of(d)
                           for j, d in zip(jpegs, device_jpegs[fused]))
                if same != N_IMG:
                    raise AssertionError(f"tpu fused={fused}: {N_IMG - same}"
                                         f" scans differ from 'device''s")
                row["scan_identical_to_device"] = same
            else:
                raw[fused] = jpegs
                with mock.patch.object(jb, "yuv420_pack", yuv420_pack_plain):
                    plain = p(corpus)
                same = sum(bytes(a) == bytes(b)
                           for a, b in zip(jpegs, plain))
                if same != N_IMG:
                    raise AssertionError(f"raw420 fused={fused}: "
                                         f"{N_IMG - same} outputs differ "
                                         f"from the plain K31 path's")
                row["identical_to_plain_k31_path"] = same
                if fused:
                    k31_launches = {"yuv420_pack": counts["yuv420_pack"]}
            out[f"{backend}_fused_{fused}"] = row
            p.close()
    phase("slice_raw420", card=card, images=N_IMG, limit_lsb=PARITY_LSB,
          fused=out["raw420_fused_True"], staged=out["raw420_fused_False"])
    phase("slice_tpu", card=card, images=N_IMG, limit_lsb=PARITY_LSB,
          fused=out["tpu_fused_True"], staged=out["tpu_fused_False"],
          note="the scan bytes of encode_backend='device'; the header is "
               "libjpeg's (DHT order DC0 AC0 DC1 AC1), the reference's "
               "'tpu' header, where 'device' writes DC0 DC1 AC0 AC1")

    # 27. a forced overflow takes the reference's raw420 fallback
    p = JpegBatchPipeline(fused=True, encode_backend="device",
                          scan_byte_cap=16384, **kw)
    reset_launch_counts()
    jpegs = p(corpus)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    clone = p._overflow_clone
    if (p.overflow_retries, p.overflow_fallbacks) != (0, 1) or clone is None \
            or (clone._encode_backend, clone._upload) != ("raw420", "gap4") \
            or not counts.get("coef_gap4_restore") \
            or counts.get("yuv420_pack") != 1:
        raise AssertionError(f"overflow: counters {p.overflow_retries}, "
                             f"{p.overflow_fallbacks}, launches {counts}")
    lsb = mean_abs(jpegs, strict)
    same = sum(bytes(a) == bytes(b) for a, b in zip(jpegs, raw[True]))
    if max(lsb) > PARITY_LSB or same != N_IMG:
        raise AssertionError(f"overflow fallback: {max(lsb)} LSB, "
                             f"{N_IMG - same} outputs differ from raw420's")
    p.close()
    phase("overflow_raw420", card=card, images=N_IMG, scan_byte_cap=16384,
          overflow_fallbacks=1, clone_upload="gap4", launches=counts,
          lsb_vs_strict_mean=sum(lsb) / N_IMG, lsb_vs_strict_max=max(lsb),
          identical_to_raw420_slice=same)

    # 28. the four encode backends, fused restart-8, timed in turns
    pipes = {b: JpegBatchPipeline(fused=True, encode_backend=b, **kw)
             for b in ("device", "tpu", "raw420", "host")}
    e2e = {b: [] for b in pipes}
    for r in range(5):
        order = list(pipes) if r % 2 == 0 else list(reversed(pipes))
        for b in order:
            e2e[b].append(wall(lambda: pipes[b](corpus), 1))
    rows = {}
    for b, p in pipes.items():
        sig_out = p._process(p.entropy_decode(corpus))
        torch.cuda.synchronize()
        res = sig_out[1][1][0]
        if b == "device":
            nb = res[1].cpu().numpy()
            d2h = 4 * N_IMG + N_IMG * min(
                res[0].shape[1], -(-int(nb.max()) // 65536) * 65536)
        elif b == "tpu":
            d2h = sum(c.numel() * c.element_size() for c in res)
        else:
            d2h = res.numel() * res.element_size()
        device_ms = timed(lambda: p.run_bucket(sig, wire_dev, ks), 10)
        finish_ms = wall(lambda: p._finish(*sig_out), 5)
        e2e_ms = sorted(e2e[b])[len(e2e[b]) // 2]
        rows[b] = dict(d2h_bytes=int(d2h), device_ms=device_ms,
                       readback_and_host_encode_ms=finish_ms,
                       e2e_ms=e2e_ms, e2e_mpix_s=mpix / e2e_ms * 1e3)
        p.close()
    rows["raw420"]["host_writer_batch_8_threads_ms"] = \
        writer["raw420_batch_8_threads_ms"]
    rows["tpu"]["host_writer_batch_8_threads_ms"] = \
        writer["coefficients_batch_8_threads_ms"]
    phase("timing_encode_backends", card=card, images=N_IMG,
          mpix_per_batch=mpix, **rows,
          note="fused restart-8 slice, upload='scan'; e2e medians of 5 "
               "rounds taken in turns; device_ms: the uploaded wire "
               "through the backend's device stages (CUDA events)")
    return k31_launches


def _leaf_names(tree, prefix=""):
    """(path, leaf) pairs in tree_leaves order (dict keys sorted, None
    holding no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_names(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _idat(png: bytes) -> bytes:
    """The concatenated IDAT payloads of a PNG file."""
    pos, data = 8, b""
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        if png[pos + 4:pos + 8] == b"IDAT":
            data += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return data


if __name__ == "__main__":
    sys.exit(main())
