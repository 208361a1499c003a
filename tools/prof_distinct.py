"""Per-stage profile of the distinct-content end-to-end decode path.

Attributes the gap between the distinct-content end-to-end rate and the
host-parse-only rate.  This tool runs the exact decode_step path with H263_TPU_TRACE stage timers plus a per-step wall breakdown and
prints where every millisecond goes, for both corpus regimes.

Usage:   python tools/prof_distinct.py --streams 256 --frames 24
CPU sanity: JAX_PLATFORMS=cpu python tools/prof_distinct.py --streams 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--transport", default="d24")
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
    n_corp = 24
    distinct = [build_corpus(W, H, F, seed=100 + c) for c in range(n_corp)]
    dist_lists = [[distinct[s % n_corp][t] for s in range(S)]
                  for t in range(F)]
    shared_lists = [[corpus[t]] * S for t in range(F)]

    mbs = (-(-W // 16)) * (-(-H // 16))
    dec = BatchedStreamDecoder(S, W, H,
                               DecoderOption.SORENSON_SPARK_BITSTREAM,
                               pack_cap=10 * mbs,
                               coef_transport=args.transport)

    # Warm both signatures (I-frame full bucket, P-frame small bucket).
    y, _, _ = dec.decode_step(shared_lists[0])
    y.block_until_ready()
    y, _, _ = dec.decode_step(shared_lists[1])
    y.block_until_ready()

    def run_regime(name, lists):
        # Re-prime references with this regime's I+first P.
        y, _, _ = dec.decode_step(lists[0])
        y, _, _ = dec.decode_step(lists[1])
        y.block_until_ready()
        trace.reset_metrics()
        steps = []
        best = None
        for p in range(args.passes):
            t0 = time.perf_counter()
            for t in range(2, F):
                ts = time.perf_counter()
                y, cb, cr = dec.decode_step(lists[t])
                steps.append(time.perf_counter() - ts)
            y.block_until_ready()
            dt = time.perf_counter() - t0
            fps = S * (F - 2) / dt
            best = fps if best is None else max(best, fps)
            print(f"  pass {p}: {fps:.1f} f/s "
                  f"({1e3 * dt / (F - 2):.2f} ms/step)", file=sys.stderr)
        m = trace.get_metrics()
        sa = np.array(steps) * 1e3
        print(f"== {name}: best {best:.1f} f/s; per-step wall "
              f"mean {sa.mean():.2f} p50 {np.percentile(sa, 50):.2f} "
              f"max {sa.max():.2f} ms", file=sys.stderr)
        for k in sorted(m):
            v = m[k]
            print(f"   {k:24s} n={v['count']:4d} mean={v['mean_ms']:7.3f} "
                  f"min={v['min_ms']:7.3f} max={v['max_ms']:8.3f} "
                  f"total={v['total_s']*1e3:9.1f} ms", file=sys.stderr)
        return best, m

    res = {}
    for name, lists in (("shared", shared_lists), ("distinct", dist_lists)):
        best, m = run_regime(name, lists)
        res[name] = {"best_fps": best, "stages": m}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
