"""TIFF LZW strip decode over a batch: kernel K15.

The port's form of the reference's host stage `native.lzw_decode` /
`native.lzw_decode_multi` (`picha_tpu/native/src/lzw.cc:85-190`, called
by `picha_tpu/codecs/tiff.py:158` and `:312`), which cannot build on the
card machine. The semantics are lzw.cc's: MSB-first codes of 9 to 12
bits, Clear 256, EOI 257; the decoder widens early, when its next free
code reaches (1 << width) - 1; the first code after a Clear must be a
literal; an undefined code (past the next free one) or a stale entry is
an error; KwKwK copies byte by byte; output stops at the strip's cap and
the rest of the stream is ignored (libtiff); the end of the input ends
the strip.

  `lzw_decode_plain`  pure Python on bytes, one strip: the correctness
                      twin of the kernel (slow; tests and checks only)
  `lzw_decode`        every strip of a batch: K15 (`csrc/lzw_decode.cu`,
                      a block a strip, each epoch's codes decoded in
                      parallel) for CUDA tensors, the plain version strip
                      by strip for CPU tensors
  `kernel_info`       K15's registers, spill and shared bytes, threads and
                      resident blocks, read from the card
  `check_strips`      one readback of the strips' statuses and lengths;
                      raises CodecError("LZW decode failed") or
                      CodecError("TIFF strip too short")
"""
from __future__ import annotations

import torch

from ..errors import CodecError
from ..kernels._build import KERNELS, ptr, require_cuda, stream_of

CLEAR, EOI, FIRST, TABLE = 256, 257, 258, 4096


def lzw_decode_plain(data: bytes, cap: int):
    """One LZW strip -> (decoded bytes, at most `cap` of them; ok)."""
    data = bytes(data)
    n_in = len(data)
    pos = acc = nbits = 0
    tpos, tlen = [0] * TABLE, [0] * TABLE
    out = bytearray()
    width, nxt, old = 9, FIRST, -1
    w_old = len_old = 0
    while True:
        while nbits < width and pos < n_in:
            acc = (acc << 8) | data[pos]
            pos += 1
            nbits += 8
        if nbits < width:
            break                               # end of the input
        nbits -= width
        code = (acc >> nbits) & ((1 << width) - 1)
        acc &= (1 << nbits) - 1
        if code == EOI:
            break
        if code == CLEAR:
            width, nxt, old = 9, FIRST, -1
            continue
        written = len(out)
        if old < 0:
            if code >= FIRST:
                return bytes(out), False
            if written >= cap:
                break
            out.append(code)
            w_old, len_old, old = written, 1, code
            continue
        if code > nxt or (code == nxt and nxt >= TABLE):
            return bytes(out), False            # undefined code
        if nxt < TABLE:
            tpos[nxt], tlen[nxt] = w_old, len_old + 1
            nxt += 1
        if code < 256:
            if written >= cap:
                break
            out.append(code)
            n = 1
        else:
            n, sp = tlen[code], tpos[code]
            if n == 0:
                return bytes(out), False        # stale entry
            if written + n > cap:
                n = cap - written
                for i in range(n):
                    out.append(out[sp + i])
                break
            if sp + n <= written:
                out += out[sp:sp + n]
            else:                               # KwKwK
                for i in range(n):
                    out.append(out[sp + i])
        w_old, len_old, old = written, n, code
        if nxt == (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out), True


def lzw_decode(segs, seg_off, seg_len, out, out_off, cap):
    """Decode every strip of a batch into `out`.

    segs: (S,) uint8, the strips back to back; seg_off and seg_len (K,)
    int64 into segs; out: a contiguous uint8 tensor, strip k written
    from flat offset out_off[k] (int64), at most cap[k] (int64, < 2^31)
    bytes. Returns ((K,) int32 decoded lengths, (K,) int32 statuses, 1 =
    failed) without reading them back (`check_strips` does). Launches
    K15 for CUDA tensors; the plain version runs only for CPU tensors."""
    k = int(seg_off.shape[0])
    if out.device.type == "cpu":
        got = torch.zeros((k,), dtype=torch.int32)
        status = torch.zeros((k,), dtype=torch.int32)
        flat = out.view(-1)
        for s in range(k):
            o, n = int(seg_off[s]), int(seg_len[s])
            data, ok = lzw_decode_plain(segs[o:o + n].numpy().tobytes(),
                                        int(cap[s]))
            if data:
                dst = int(out_off[s])
                flat[dst:dst + len(data)] = torch.frombuffer(
                    bytearray(data), dtype=torch.uint8)
            got[s], status[s] = len(data), 0 if ok else 1
        return got, status
    require_cuda(out, "K15")
    for t, dtype in ((segs, torch.uint8), (seg_off, torch.int64),
                     (seg_len, torch.int64), (out_off, torch.int64),
                     (cap, torch.int64), (out, torch.uint8)):
        if t.device != out.device or t.dtype != dtype or \
                not t.is_contiguous():
            raise TypeError(f"K15 takes contiguous {dtype} tensors on "
                            f"{out.device}, got {t.dtype} on {t.device}")
    got = torch.empty((k,), dtype=torch.int32, device=out.device)
    status = torch.empty((k,), dtype=torch.int32, device=out.device)
    KERNELS["lzw_decode"](ptr(segs), ptr(seg_off), ptr(seg_len), ptr(out_off),
                          ptr(cap), k, ptr(out), ptr(got), ptr(status),
                          stream_of(out))
    return got, status


_INFO = ("registers", "local_bytes", "shared_bytes", "threads",
         "blocks_per_sm")


def kernel_info() -> dict:
    """K15's build as the card reports it: registers and local (spill)
    bytes a thread, shared bytes and threads a block, resident blocks a
    multiprocessor. Launches nothing and counts no launch."""
    import ctypes

    from ..kernels._build import library

    vals = (ctypes.c_int * len(_INFO))()
    rc = library().picha_lzw_decode_info(vals)
    if rc != 0:
        raise RuntimeError(f"picha_lzw_decode_info: CUDA error {rc}")
    return dict(zip(_INFO, vals))


def check_strips(got, status, need):
    """Read the strip results back once: raise CodecError when a strip
    failed, or came out shorter than `need` (its rows' bytes)."""
    failed, short = torch.stack(
        [status != 0, got.to(need.dtype) < need.to(got.device)]).cpu()
    if bool(failed.any()):
        raise CodecError("LZW decode failed")
    if bool(short.any()):
        raise CodecError("TIFF strip too short")
