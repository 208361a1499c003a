#!/usr/bin/env python3
"""Throughput-style example: N concurrent CIF Sorenson streams decoded in
lockstep on one device, with optional multi-device stream sharding.

Usage:
    python examples/batched_streams.py [--streams 64] [--frames 12] [--shard]

Synthesizes one shared GOP with the test encoder (every stream decodes the
same bits here; real deployments feed per-stream buffers — the device
program is content-independent).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--shard", action="store_true",
                    help="shard the stream axis over all devices")
    args = ap.parse_args()

    from h263_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from h263_tpu.parallel import BatchedStreamDecoder
    from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu.types import PictureTypeCode

    W, H, mbw, mbh = 352, 288, 22, 18
    rng = np.random.default_rng(0)
    corpus = [encode_sorenson_picture(
        W, H, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6)
         for _ in range(mbw * mbh)], quantizer=8)]
    for tr in range(1, args.frames):
        corpus.append(encode_sorenson_picture(
            W, H, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(1, 1)],
                    blocks=[[(0, 6)], [], [], [], [], []]
                    if k % 7 == 0 else [[], [], [], [], [], []])
             for k in range(mbw * mbh)], quantizer=8, temporal_reference=tr))

    kw = {}
    if args.shard:
        from h263_tpu.parallel import make_stream_mesh, shard_reconstruct_fn

        mesh = make_stream_mesh()
        kw["packed_reconstruct_fn"] = shard_reconstruct_fn(
            mesh, H, W, packed=True)
        print(f"sharding {args.streams} streams over {mesh.size} devices")

    dec = BatchedStreamDecoder(args.streams, W, H, **kw)
    y, cb, cr = dec.decode_step([corpus[0]] * args.streams)  # compile I path
    y, cb, cr = dec.decode_step([corpus[1]] * args.streams)  # compile P path
    y.block_until_ready()

    t0 = time.perf_counter()
    for t in range(2, args.frames):
        y, cb, cr = dec.decode_step([corpus[t]] * args.streams)
    y.block_until_ready()
    dt = time.perf_counter() - t0
    fps = args.streams * (args.frames - 2) / dt
    print(f"{fps:.0f} frames/s ({args.streams} streams, "
          f"{1e3 * dt / (args.frames - 2):.2f} ms/step)")

    rgba = dec.present_rgba()  # deblock (per-stream flag) + BT.601, on device
    print(f"presented RGBA batch: {tuple(rgba.shape)} {rgba.dtype}")


if __name__ == "__main__":
    main()
