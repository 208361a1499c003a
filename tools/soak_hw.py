"""On-device bit-exactness soak through the production decode path.

Decodes a rich synthetic Sorenson GOP — mixed intra / inter / four-MV /
uncoded macroblocks, DQUANT steps, escape-range levels (both 7- and
11-bit Sorenson widths), a DisposableP frame, per-frame PQUANT changes —
through `BatchedStreamDecoder`'s default path (native fused single-leaf
d24 transport; the four-MV content forces the slim->full MV flip mid-GOP)
or the device front-end, then verifies EVERY frame's three planes, and the
present (deblock + BT.601 RGBA) output every K frames, bit-exactly against
the numpy golden decoder (reference arithmetic: idct.rs/gather.rs/rle.rs;
deblock.rs; bt601.rs).  Mismatches are counted on the device; only the
counts come back.

chip_smoke.py runs it as one phase (`run_soak`).  Standalone:

    python tools/soak_hw.py --frames 60 --streams 4
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_disable_hlo_passes=fusion \
        python tools/soak_hw.py --frames 12 --streams 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rich_gop(width: int, height: int, n_frames: int, seed: int):
    """Frames (bytes) + per-frame PQUANT list for one stream."""
    from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu.types import PictureTypeCode

    rng = np.random.default_rng(seed)
    nmb = (-(-width // 16)) * (-(-height // 16))
    disposable_t = max(2, n_frames // 2)
    frames, quants = [], []

    def events(max_events, escape_ok):
        evs = []
        for _ in range(int(rng.integers(0, max_events + 1))):
            run = int(rng.integers(0, 9))
            if escape_ok and rng.random() < 0.15:
                # Escape-range levels: exercise both Sorenson widths.
                level = int(rng.choice([70, -70, 300, -300]))
            else:
                level = int(rng.integers(1, 13)) * int(rng.choice([1, -1]))
            evs.append((run, level))
        return evs

    q = 8
    for t in range(n_frames):
        quants.append(q)
        if t == 0:
            mbs = [MBSpec(kind="intra",
                          intradc=[int(rng.integers(1, 128)) * 8] * 6,
                          blocks=[events(3, False), events(2, False),
                                  [], [], events(1, False), []])
                   for _ in range(nmb)]
            frames.append(encode_sorenson_picture(
                width, height, PictureTypeCode.I_FRAME, mbs,
                quantizer=q, temporal_reference=t & 0xFF))
        elif t == disposable_t:
            # All-uncoded DisposableP (any coded MB in one is the
            # reference's UnimplementedDecoding quirk); must not become a
            # reference for the following P-frames.
            frames.append(encode_sorenson_picture(
                width, height, PictureTypeCode.DISPOSABLE_P_FRAME,
                [MBSpec(kind="uncoded")] * nmb,
                quantizer=q, temporal_reference=t & 0xFF, pad_bit=1))
        else:
            mbs = []
            for _ in range(nmb):
                roll = rng.random()
                if roll < 0.18:
                    mbs.append(MBSpec(kind="uncoded"))
                elif roll < 0.28:
                    mbs.append(MBSpec(
                        kind="intra",
                        intradc=[int(rng.integers(1, 128)) * 8] * 6,
                        blocks=[events(2, True), [], [], [], [], []]))
                else:
                    n_mv = 4 if rng.random() < 0.25 else 1
                    mvds = [(int(rng.integers(-10, 11)),
                             int(rng.integers(-10, 11)))
                            for _ in range(n_mv)]
                    dq = int(rng.choice([0, 0, 0, 0, 0, 0, 1, -1, 2, -2]))
                    mbs.append(MBSpec(
                        kind="inter", mvd=mvds, dquant=dq,
                        blocks=[events(3, True), events(1, False),
                                [], [], events(1, False), []]))
            frames.append(encode_sorenson_picture(
                width, height, PictureTypeCode.P_FRAME, mbs,
                quantizer=q, temporal_reference=t & 0xFF))
            if rng.random() < 0.3:
                q = int(rng.integers(4, 16))
    return frames, quants


def run_soak(S: int, T: int, W: int, H: int, present_every: int = 15,
             frontend: str = "host", log=None) -> dict:
    """Decode S distinct rich GOPs of T frames through the production path
    and compare with the numpy golden.  Returns {check name: mismatching
    sample count}; every count is 0 when the decode is bit-exact."""
    import jax
    import jax.numpy as jnp

    from h263_tpu.decoder.state import H263Decoder
    from h263_tpu.ops.deblock import QUANT_TO_STRENGTH, golden_deblock
    from h263_tpu.ops.yuv import golden_yuv420_to_rgba
    from h263_tpu.parallel.batch import BatchedStreamDecoder
    from h263_tpu.types import DecoderOption

    log = log or (lambda *a: print(*a, file=sys.stderr))
    t0 = time.perf_counter()
    gops, quantss = [], []
    for s in range(S):
        f, qs = rich_gop(W, H, T, seed=1000 + s)
        gops.append(f)
        quantss.append(qs)
    log(f"{S} distinct {T}-frame GOPs encoded in "
        f"{time.perf_counter() - t0:.1f}s")

    # Numpy goldens (reference-arithmetic scalar path), per stream/frame.
    t0 = time.perf_counter()
    singles = [H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM,
                           backend="numpy") for _ in range(S)]
    per_t = []
    for t in range(T):
        planes = [[], [], []]
        for s in range(S):
            pic = singles[s].decode_next_picture(gops[s][t])
            planes[0].append(np.asarray(pic.as_luma()))
            planes[1].append(np.asarray(pic.as_chroma_b()))
            planes[2].append(np.asarray(pic.as_chroma_r()))
        per_t.append([np.stack(p) for p in planes])
    gold = [np.stack([per_t[t][p] for t in range(T)]) for p in range(3)]
    log(f"numpy goldens decoded in {time.perf_counter() - t0:.1f}s")

    # Present goldens at the cadence.
    pres_ts = list(range(present_every - 1, T, present_every))
    gold_rgba = {}
    for t in pres_ts:
        frames_rgba = []
        for s in range(S):
            strength = int(QUANT_TO_STRENGTH[quantss[s][t] & 31])
            y = golden_deblock(per_t[t][0][s], strength)
            cb = golden_deblock(per_t[t][1][s], strength)
            cr = golden_deblock(per_t[t][2][s], strength)
            frames_rgba.append(golden_yuv420_to_rgba(y, cb, cr))
        gold_rgba[t] = np.stack(frames_rgba)

    if frontend == "device":
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        dec = DeviceFrontendDecoder(
            S, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM)
        tag = f"harness={dec.harness} payload={dec.payload}"
    else:
        dec = BatchedStreamDecoder(S, W, H,
                                   DecoderOption.SORENSON_SPARK_BITSTREAM)
        tag = f"fused={dec._fused_enabled}"
    outs, pres = [], {}
    t0 = time.perf_counter()
    for t in range(T):
        y, cb, cr = dec.decode_step([gops[s][t] for s in range(S)])
        outs.append((y, cb, cr))
        if t in pres_ts:
            pres[t] = dec.present_rgba(deblock=True)
    outs[-1][0].block_until_ready()
    log(f"device decode: {T} steps in {time.perf_counter() - t0:.1f}s "
        f"({tag})")

    count = jax.jit(lambda a, b: jnp.sum(jnp.not_equal(a, b),
                                         dtype=jnp.int32))
    verdicts = {}
    for p, name in ((0, "y"), (1, "cb"), (2, "cr")):
        verdicts[name] = count(jnp.stack([o[p] for o in outs]),
                               jax.device_put(gold[p]))
    for t in pres_ts:
        verdicts[f"rgba@t{t}"] = count(pres[t], jax.device_put(gold_rgba[t]))
    return {name: int(v) for name, v in verdicts.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--width", type=int, default=176)
    ap.add_argument("--height", type=int, default=144)
    ap.add_argument("--present-every", type=int, default=15)
    ap.add_argument("--frontend", choices=("host", "device"), default="host",
                    help="entropy front-end under soak: the host batched "
                         "path (default) or the device automaton")
    args = ap.parse_args()

    from h263_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    S, T, W, H = args.streams, args.frames, args.width, args.height
    counts = run_soak(S, T, W, H, args.present_every, args.frontend)
    for name, n in counts.items():
        status = "bit-exact" if n == 0 else f"MISMATCH ({n} samples)"
        print(f"{name:>10}: {status}")
    if any(counts.values()):
        sys.exit(1)
    print(f"SOAK OK: {T} frames x {S} streams ({W}x{H}), all planes and "
          f"{len(counts) - 3} RGBA checks bit-exact vs the numpy golden")


if __name__ == "__main__":
    main()
