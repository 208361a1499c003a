"""Instrument the pipelined (submit_step) path vs sequential on a device.

Both stages release the GIL, so pipelining should overlap them; this tool
measures where the overlap is lost: per-step wall on the submitter thread, the
worker-side transfer/dispatch stage times, and the submitter's waits
(buffer-rotation future wait + in_flight reclaim).

Usage:   python tools/prof_pipeline.py --streams 256 --frames 24
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--regime", default="distinct", choices=["shared", "distinct"])
    args = ap.parse_args()

    from bench import build_corpus
    from h263_tpu.parallel.batch import BatchedStreamDecoder
    from h263_tpu.types import DecoderOption
    from h263_tpu.utils import trace

    trace.trace_enabled(True)

    import jax
    print(f"devices: {jax.devices()}", file=sys.stderr)

    S, F, W, H = args.streams, args.frames, 352, 288
    corpus = build_corpus(W, H, F)
    if args.regime == "distinct":
        n_corp = 24
        distinct = [build_corpus(W, H, F, seed=100 + c) for c in range(n_corp)]
        lists = [[distinct[s % n_corp][t] for s in range(S)] for t in range(F)]
    else:
        lists = [[corpus[t]] * S for t in range(F)]

    mbs = (-(-W // 16)) * (-(-H // 16))
    dec = BatchedStreamDecoder(S, W, H,
                               DecoderOption.SORENSON_SPARK_BITSTREAM,
                               pack_cap=10 * mbs)

    y, _, _ = dec.decode_step(lists[0])
    y.block_until_ready()
    y, _, _ = dec.decode_step(lists[1])
    y.block_until_ready()

    def report(tag, steps_ms):
        m = trace.get_metrics()
        sa = np.array(steps_ms)
        print(f"== {tag}: per-step wall mean {sa.mean():.2f} "
              f"p50 {np.percentile(sa, 50):.2f} max {sa.max():.2f} ms",
              file=sys.stderr)
        for k in sorted(m):
            v = m[k]
            print(f"   {k:24s} n={v['count']:4d} mean={v['mean_ms']:7.3f} "
                  f"min={v['min_ms']:7.3f} max={v['max_ms']:8.3f} "
                  f"total={v['total_s']*1e3:9.1f} ms", file=sys.stderr)

    # Interleave A/B passes: seq, pipe, seq, pipe ... (the host drifts
    # between minutes; only order-balanced comparisons mean anything).
    for p in range(args.passes):
        # -- sequential pass --
        y, _, _ = dec.decode_step(lists[0]); y, _, _ = dec.decode_step(lists[1])
        y.block_until_ready()
        trace.reset_metrics()
        steps = []
        t0 = time.perf_counter()
        for t in range(2, F):
            ts = time.perf_counter()
            y, cb, cr = dec.decode_step(lists[t])
            steps.append(1e3 * (time.perf_counter() - ts))
        y.block_until_ready()
        fps = S * (F - 2) / (time.perf_counter() - t0)
        print(f"pass {p} sequential: {fps:.1f} f/s", file=sys.stderr)
        report(f"seq p{p}", steps)

        # -- pipelined pass --
        y, _, _ = dec.decode_step(lists[0]); y, _, _ = dec.decode_step(lists[1])
        y.block_until_ready()
        trace.reset_metrics()
        steps = []
        t0 = time.perf_counter()
        last = None
        for t in range(2, F):
            ts = time.perf_counter()
            last = dec.submit_step(lists[t])
            steps.append(1e3 * (time.perf_counter() - ts))
        for a in last.result():
            a.block_until_ready()
        fps = S * (F - 2) / (time.perf_counter() - t0)
        print(f"pass {p} pipelined: {fps:.1f} f/s", file=sys.stderr)
        report(f"pipe p{p}", steps)


if __name__ == "__main__":
    main()
