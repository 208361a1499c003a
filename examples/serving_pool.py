#!/usr/bin/env python3
"""Serving-shaped demo: a mixed-resolution stream pool with live churn.

Simulates a small serving workload against StreamPool:
  * streams of two resolutions decode concurrently (per-resolution
    bucketed batches, SURVEY.md §7 hard part 4)
  * a stream joins mid-run (slot recycle / bucket growth, no per-step
    shape churn)
  * a stream skips steps (its slot pads with skip frames; state intact)
  * a stream switches resolution at an I-frame (transparent rebucket)
  * a stream leaves (slot freed for the next join)

Every decoded frame is checked bit-exact against an independent
single-stream H263Decoder.  Runs self-contained (the bitstreams come from
the spec-table test encoder).

Usage: python examples/serving_pool.py [--steps N] [--frontend device]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from h263_tpu import DecoderOption, H263Decoder, PictureTypeCode
from h263_tpu.parallel.pool import StreamPool
from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu.utils.compile_cache import enable_compile_cache

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def make_gop(seed, w, h, n):
    rng = np.random.default_rng(seed)
    nmb = (-(-w // 16)) * (-(-h // 16))
    frames = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
         for _ in range(nmb)], temporal_reference=0)]
    for tr in range(1, n):
        frames.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter",
                    mvd=[(int(rng.integers(-4, 5)) * 2,
                          int(rng.integers(-4, 5)) * 2)],
                    blocks=[[(0, int(rng.integers(1, 6)))], [], [], [], [], []])
             for _ in range(nmb)], temporal_reference=tr & 0xFF))
    return frames


class SimStream:
    """A stream with its own frame supply and an oracle decoder."""

    def __init__(self, sid, seed, w, h, n):
        self.sid = sid
        self.w, self.h = w, h
        self.frames = iter(make_gop(seed, w, h, n))
        self.oracle = H263Decoder(SORENSON, backend="numpy")

    def next_frame(self):
        return next(self.frames, None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--frontend", choices=("host", "device"), default="host",
                    help="bucket decoder: host entropy parse (default) or "
                         "the device entropy automaton")
    args = ap.parse_args()

    enable_compile_cache()
    pool = StreamPool(SORENSON, frontend=args.frontend)
    streams = {}

    def start(sid, seed, w, h, n=20):
        s = SimStream(sid, seed, w, h, n)
        streams[sid] = s
        pool.add_stream(sid, w, h)
        print(f"  + {sid} joined ({w}x{h})")

    start("news", 1, 176, 144)
    start("talk", 2, 176, 144)
    start("cam", 3, 128, 96)

    checked = 0
    for step in range(args.steps):
        if step == 2:
            start("late", 9, 128, 96)       # join mid-run
        if step == 4:
            pool.remove_stream("talk")       # leave
            streams.pop("talk")
            print("  - talk left")
        if step == 6:
            # cam switches to 176x144 at an I-frame: rebucket
            streams["cam"] = SimStream("cam", 30, 176, 144, 20)
            print("  ~ cam switches to 176x144 (I-frame rebucket)")

        buffers = {}
        for sid, s in streams.items():
            if sid == "news" and step in (3, 5):
                continue  # news skips these steps; its slot pads
            buf = s.next_frame()
            if buf is not None:
                buffers[sid] = buf
        out = pool.decode_step(buffers)
        # `out` is device-resident (PoolStepResult): nothing has crossed
        # the device->host link yet.  A serving loop that only chains
        # steps (or post-processes via out.device_planes(sid)) performs
        # ZERO readbacks; indexing below is the explicit per-stream fetch
        # this demo uses to check bit-exactness.
        for sid, (y, cb, cr) in out.items():
            pic = streams[sid].oracle.decode_next_picture(buffers[sid])
            np.testing.assert_array_equal(y, pic.as_luma(),
                                          err_msg=f"{sid} step {step}")
            checked += 1
        print(f"step {step}: decoded {sorted(out)} "
              f"({len(out)} frames, all bit-exact)")

    # K-frame megastep (device front-end pools): a window of T frames
    # decodes with ONE ragged transfer leaf + ONE dispatch per bucket
    # (pool.decode_steps), amortizing the per-call host RPC floor that
    # bounds single-frame serving — the round-5 serving shape.  Host
    # pools transparently fall back to T sequential steps.
    window = []
    for _ in range(3):
        bufs = {sid: s.next_frame() for sid, s in streams.items()}
        window.append({sid: b for sid, b in bufs.items() if b is not None})
    if all(window):
        outs = pool.decode_steps(window)
        for t, out in enumerate(outs):
            for sid, (y, _, _) in out.items():
                pic = streams[sid].oracle.decode_next_picture(window[t][sid])
                np.testing.assert_array_equal(
                    y, pic.as_luma(), err_msg=f"{sid} window frame {t}")
        print(f"megastep window: {len(window)} frames x {len(outs[0])} "
              f"streams in one dispatch per bucket, bit-exact")

    rgba = pool.present_rgba(deblock=False)
    shapes = {sid: a.shape for sid, a in sorted(rgba.items())}
    print(f"present_rgba shapes: {shapes}")

    # Suspend/migrate: snapshot the WHOLE pool (membership, slot maps,
    # per-bucket decoder states), resume it as a fresh object, and decode
    # one more step — bit-exact continuation.
    from h263_tpu.utils.checkpoint import load_pool_state, save_pool_state

    blob = save_pool_state(pool)
    resumed = load_pool_state(blob)
    buffers = {sid: s.next_frame() for sid, s in streams.items()}
    buffers = {sid: b for sid, b in buffers.items() if b is not None}
    if buffers:
        out = resumed.decode_step(buffers)
        for sid, (y, _, _) in out.items():
            pic = streams[sid].oracle.decode_next_picture(buffers[sid])
            np.testing.assert_array_equal(y, pic.as_luma(),
                                          err_msg=f"{sid} post-resume")
        print(f"checkpoint/resume: {len(blob)}-byte pool snapshot, "
              f"{len(out)} streams continued bit-exact")

    from h263_tpu.utils import get_counters

    print(f"serving counters: {get_counters()}")
    print(f"OK: {checked} frames decoded through the pool, "
          f"bit-exact vs single-stream decoders")


if __name__ == "__main__":
    main()
