#!/usr/bin/env python3
"""Decode the Sorenson Spark video track of an FLV file to PPM frames.

Usage:
    python examples/decode_flv.py input.flv out_dir [--max-frames N]
    python examples/decode_flv.py --selftest

The single-stream path mirrors the reference decoder's API
(h263-rs: H263State::decode_next_picture); `--selftest` synthesizes a tiny
FLV in memory with the test encoder and round-trips it, so the example runs
without any input file.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from h263_tpu import DecoderOption, H263Decoder
from h263_tpu.io.flv import iter_flv_video_tags
from h263_tpu.utils.compile_cache import enable_compile_cache


def write_ppm(path: str, rgba: np.ndarray) -> None:
    h, w = rgba.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgba[:, :, :3]).tobytes())


def decode_flv(data: bytes, out_dir: str | None, max_frames: int | None):
    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM)
    n = 0
    for tag in iter_flv_video_tags(data):
        pic = dec.decode_next_picture(tag.payload)
        if pic is None:
            continue
        rgba = dec.last_picture_rgba()
        if out_dir is not None:
            write_ppm(os.path.join(out_dir, f"frame_{n:05d}.ppm"),
                      np.asarray(rgba))
        n += 1
        if max_frames is not None and n >= max_frames:
            break
    return n


def _synth_flv() -> bytes:
    """A minimal FLV wrapping a 3-frame synthetic Sorenson GOP."""
    from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu.types import PictureTypeCode

    W, H, mbw, mbh = 176, 144, 11, 9
    rng = np.random.default_rng(1)
    frames = [encode_sorenson_picture(
        W, H, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6)
         for _ in range(mbw * mbh)], quantizer=8)]
    for tr in (1, 2):
        frames.append(encode_sorenson_picture(
            W, H, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, -2)])] * (mbw * mbh),
            quantizer=8, temporal_reference=tr))

    out = bytearray(b"FLV\x01\x01\x00\x00\x00\x09\x00\x00\x00\x00")
    ts = 0
    for i, payload in enumerate(frames):
        body = bytes([(1 if i == 0 else 2) << 4 | 2]) + payload  # frametype|codec=2
        out += bytes([9])                                # video tag
        out += struct.pack(">I", len(body))[1:]          # 24-bit size
        out += struct.pack(">I", ts)[1:] + bytes([0])    # ts24 + ext
        out += b"\x00\x00\x00"                           # stream id
        out += body
        out += struct.pack(">I", 11 + len(body))         # prev tag size
        ts += 33
    return bytes(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("flv", nargs="?")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args()

    enable_compile_cache()
    if args.selftest:
        n = decode_flv(_synth_flv(), None, None)
        assert n == 3, n
        print("selftest OK: decoded 3 synthetic frames")
        return
    if not args.flv or not args.out_dir:
        ap.error("flv and out_dir required (or --selftest)")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(args.flv, "rb") as f:
        data = f.read()
    n = decode_flv(data, args.out_dir, args.max_frames)
    print(f"decoded {n} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
