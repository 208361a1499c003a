"""A/B: single-step vs K-frame megastep device-front-end serving.

At the serving shape the single-frame step may be bound by the per-call
host floor (prep + transfer + dispatch).  decode_steps ships K frames in
ONE transfer leaf and runs K automaton frames per dispatch (lax.scan
carries the reference planes on device), paying the floor once per K
frames.  This tool measures both paths ORDER-BALANCED (mirror-ordered
groups) in one process so drift cannot masquerade as a win.  All timing
completes before any readback.

Usage:       python tools/prof_megastep.py --streams 2048
CPU sanity:  python tools/prof_megastep.py --cpu --streams 8 \
                 --frames 8 --groups 1 --windows 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=352)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--windows", default="4,8",
                    help="comma-separated K values to A/B against the "
                         "single step")
    ap.add_argument("--groups", type=int, default=3,
                    help="ABBA groups per K")
    ap.add_argument("--distinct-corpora", type=int, default=24)
    ap.add_argument("--tape-per-mb", type=int, default=16)
    ap.add_argument("--max-frame-bytes", type=int, default=0,
                    help="payload cap per frame; 0 = auto-size from the "
                         "corpus (needed for non-CIF shapes, e.g. 720p)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    log(f"devices: {jax.devices()}")

    from bench import build_corpus  # same corpus generator as the record
    from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
    from h263_tpu.types import DecoderOption

    S, F, W, H = args.streams, args.frames, args.width, args.height
    nmb = (-(-W // 16)) * (-(-H // 16))
    n_corp = args.distinct_corpora
    t0 = time.perf_counter()
    corp = [build_corpus(W, H, F, seed=100 + c) for c in range(n_corp)]
    lists = [[corp[s % n_corp][t] for s in range(S)] for t in range(F)]
    log(f"corpora: {n_corp} x {F} frames in {time.perf_counter() - t0:.1f}s")

    cap = args.max_frame_bytes
    if cap <= 0:
        # Same auto-sizing as bench.py's 720p section: cover the largest
        # corpus frame, 4 KiB-quantized, floor 8 KiB (CIF default).
        maxb = max(len(b) for c in corp for b in c)
        cap = max(8192, ((maxb + 4095) // 4096) * 4096)
    log(f"max_frame_bytes={cap}")
    dfe = DeviceFrontendDecoder(
        S, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
        tape_len=args.tape_per_mb * nmb, max_frame_bytes=cap,
        harness="xla")

    def pass_single():
        for t in range(2, F):
            y, _, _ = dfe.decode_step(lists[t])
        y.block_until_ready()
        return S * (F - 2)

    def make_pass_window(K):
        usable = ((F - 2) // K) * K
        wins = [lists[2 + k * K: 2 + (k + 1) * K]
                for k in range(usable // K)]

        def pass_window():
            for wl in wins:
                ys, _, _ = dfe.decode_steps(wl)
            ys.block_until_ready()
            return S * usable

        return pass_window

    # Warm + compile the single-step path (frames 0,1 seed the refs).
    t0 = time.perf_counter()
    y, _, _ = dfe.decode_step(lists[0])
    y.block_until_ready()
    log(f"single-step compile {time.perf_counter() - t0:.1f}s")
    dfe.decode_step(lists[1])
    pass_single()

    results = {"streams": S, "frames": F, "groups": args.groups,
               "single_fps": [], "window_fps": {}}

    # Compile every K program up front, then interleave ALL variants
    # inside each group (mirror-ordered: single, K1..Kn, Kn..K1, single)
    # so the K values are compared within the same time window.
    Ks = [int(k) for k in args.windows.split(",") if k]
    pws = {}
    for K in Ks:
        pws[K] = make_pass_window(K)
        t0 = time.perf_counter()
        dfe.decode_steps(lists[:K])  # compile T=K program + I-window rung
        log(f"K={K} window compile {time.perf_counter() - t0:.1f}s")
        pws[K]()  # compile remaining rungs + steady state
        results["window_fps"][str(K)] = []
    order = ([("single", pass_single)]
             + [(f"win{K}", pws[K]) for K in Ks]
             + [(f"win{K}", pws[K]) for K in reversed(Ks)]
             + [("single", pass_single)])
    for g in range(args.groups):
        for name, fn in order:
            t0 = time.perf_counter()
            n = fn()
            fps = n / (time.perf_counter() - t0)
            log(f"  group {g} {name}: {fps:.0f} f/s/chip")
            if name == "single":
                results["single_fps"].append(round(fps, 1))
            else:
                results["window_fps"][name[3:]].append(round(fps, 1))
        emit({"partial": True, **results})

    summary = {
        "single_best": max(results["single_fps"]),
        "single_median": float(np.median(results["single_fps"])),
        "windows": {
            k: {"best": max(v), "median": float(np.median(v)),
                "speedup_vs_single_median":
                    round(float(np.median(v))
                          / float(np.median(results["single_fps"])), 2)}
            for k, v in results["window_fps"].items() if v},
    }
    emit({"partial": False, **results, "summary": summary})


if __name__ == "__main__":
    main()
