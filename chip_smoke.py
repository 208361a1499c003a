#!/usr/bin/env python3
"""Prove that the decode path runs on one NVIDIA GPU, bit-exactly.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the stream-sharded mesh on 4 cards

One process drives the card(s); the only subprocesses are the native
compiler and `nvidia-smi`.  Every phase raises on failure and any failure
exits non-zero with no result line.  There is no CPU fallback: without a
GPU the script fails in phase 0.

Phases (one card):
  0. device: platform, card name and power limit, JAX version, compile
     cache, XLA_FLAGS (the CPU test flags are refused), a forced native
     build from the committed sources.
  1. strict f32 rounding through both front-ends at the serving shapes,
     and IDCT parity against the numpy golden on a dense coefficient
     tensor of one S=2048 CIF step (all four block classes plus the
     adversarial FMA block), tolerance 0.
  2. host path: BatchedStreamDecoder, CIF, S=256, distinct-content GOPs;
     sampled lanes against the numpy decoder, frame by frame, and
     present_rgba against golden deblock + BT.601.
  3. device front-end: DeviceFrontendDecoder, CIF, S=2048; lane status,
     planes against the host path and the numpy decoder, one K=8
     decode_steps window against the single steps, peak device memory.
  4. real-encoder content: an ffmpeg FLV through io/flv.py and the device
     front-end (with resolve_overflows) against the numpy decoder.
  5. serving pool: StreamPool steps with a join, a leave and a QCIF->CIF
     rebucket; two lanes against the numpy decoder.
  6. soak: tools/soak_hw.py, 60 frames, planes plus RGBA every 15th
     frame, through both front-ends.

--four-cards runs only the mesh phase: __graft_entry__.dryrun_multichip
at CIF with S=4x512 over a 1-D mesh of 4 GPUs, bit-compared with the
same streams decoded on one card, and the compiled programs checked for
collectives.

The last stdout line is {"ok": true, "device": {"platform": ..., "kind":
..., "count": ...}}; the line before it is the card's name and power
limit as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CIF = (352, 288)
QCIF = (176, 144)
SERVE_STREAMS = 2048      # device front-end serving shape (bench.py)
HOST_STREAMS = 256        # host-path shape (bench.py --streams)
N_CORPORA = 8             # distinct GOPs cycled over the lanes
GOP_FRAMES = 16
MEGASTEP = 8
CPU_TEST_FLAGS = ("xla_disable_hlo_passes", "xla_force_host_platform_device_count")
COLLECTIVES = re.compile(
    r"\b(all-reduce|all-gather|all-to-all|reduce-scatter|collective-permute|"
    r"collective-broadcast|ragged-all-to-all)(-start|-done)?\b")


# ---------------------------------------------------------------------------
# Helpers (host-only; the CPU tests call these at tiny shapes)
# ---------------------------------------------------------------------------


def log(*a):
    print(*a, flush=True)


def parse_nvidia_smi(text: str) -> str:
    """The first card's line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`: "<name>, <limit> W"."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or "," not in lines[0]:
        raise RuntimeError(f"unexpected nvidia-smi output: {text!r}")
    return lines[0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return parse_nvidia_smi(out)


def cpu_test_flags(xla_flags: str) -> list:
    """Flags of the CPU test harness (tests/conftest.py) found in
    XLA_FLAGS; they must never reach a GPU process."""
    return [f for f in CPU_TEST_FLAGS if f in xla_flags]


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def assert_equal(name: str, got, want) -> None:
    """Tolerance-0 comparison with the first mismatch in the message."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    bad = got != want
    if bad.any():
        idx = tuple(int(i) for i in np.argwhere(bad)[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.size} samples differ; first "
            f"at {idx}: got {got[idx]}, want {want[idx]}")


def dense_from_frame(frame) -> np.ndarray:
    """A parsed frame's coefficients in the packed-transport dense layout
    reconstruct_from_dense takes: int16 [6*nmb, 64] (luma 8x8-block grid
    row-major, then Cb, then Cr; row-major within each block)."""
    return np.concatenate([
        frame.coeffs_y.reshape(-1, 64), frame.coeffs_cb.reshape(-1, 64),
        frame.coeffs_cr.reshape(-1, 64)]).astype(np.int16)


def fma_block() -> np.ndarray:
    """The adversarial block (tests/test_ops.py TestFmaContraction): its
    residual at (0, 2) is 28 with the product rounded, 27 under FMA."""
    c = np.zeros((8, 8), dtype=np.int16)
    c[0, 2], c[0, 3], c[2, 2] = 735, -555, 215
    return c.reshape(64)


def golden_rgba(y, cb, cr, quantizer: int, deblock: bool) -> np.ndarray:
    """Host presentation: golden deblock at the Table J.2 strength of the
    picture quantizer, then golden BT.601 RGBA."""
    from h263_tpu.ops.deblock import QUANT_TO_STRENGTH, golden_deblock
    from h263_tpu.ops.yuv import golden_yuv420_to_rgba

    strength = int(QUANT_TO_STRENGTH[quantizer & 31])
    if deblock and strength > 0:
        y, cb, cr = (golden_deblock(p, strength) for p in (y, cb, cr))
    return golden_yuv420_to_rgba(y, cb, cr)


def corpora(width: int, height: int, n: int, frames: int, seed0: int = 100):
    """Distinct synthetic GOPs (bench.build_corpus), one per seed."""
    import bench

    return [bench.build_corpus(width, height, frames, seed=seed0 + c)
            for c in range(n)]


def numpy_decode(frames):
    """Every picture of one stream through the numpy golden decoder:
    [(y, cb, cr, quantizer)]."""
    from h263_tpu.decoder.state import H263Decoder
    from h263_tpu.types import DecoderOption

    dec = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM, backend="numpy")
    out = []
    for buf in frames:
        pic = dec.decode_next_picture(buf)
        out.append((pic.as_luma(), pic.as_chroma_b(), pic.as_chroma_r(),
                    pic.picture_header.quantizer))
    return out


def sample_lanes(n_streams: int, n_corpora: int) -> list:
    """Lanes covering every corpus, plus the batch's far end."""
    lanes = set(range(min(n_corpora, n_streams)))
    lanes.update({n_streams // 2, n_streams - 2, n_streams - 1})
    return sorted(lane for lane in lanes if 0 <= lane < n_streams)


class Timer:
    """Wall time and JAX compile time (trace + lowering + backend compile,
    from jax.monitoring) of a phase."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.compile_s += duration

    @contextlib.contextmanager
    def phase(self, name: str):
        t0, c0 = time.perf_counter(), self.compile_s
        log(f"[{name}] start")
        yield
        log(f"[{name}] ok: wall {time.perf_counter() - t0:.1f} s, compile "
            f"{self.compile_s - c0:.1f} s")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def require_gpu():
    """jax.devices(), or RuntimeError when JAX found no GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devices}")
    return devices


def phase_device(card: str) -> None:
    import jax

    from h263_tpu.native import bindings
    from h263_tpu.utils.compile_cache import cache_dir

    devices = require_gpu()
    flags = os.environ.get("XLA_FLAGS", "")
    log(f"card: {card}")
    log(f"jax {jax.__version__}; devices: {len(devices)} x "
        f"{devices[0].device_kind}")
    log(f"compile cache: {cache_dir()}")
    log(f"XLA_FLAGS: {flags!r}")
    bad = cpu_test_flags(flags)
    if bad:
        raise RuntimeError(f"CPU test flags in XLA_FLAGS: {bad}")
    t0 = time.perf_counter()
    if not bindings.ensure_built(force_rebuild=True):
        raise RuntimeError("native entropy front-end failed to build/load")
    log(f"native front-end built on this host in "
        f"{time.perf_counter() - t0:.1f} s; fastcall helper loaded: "
        f"{bindings.fastcall_loaded()}")


def idct_parity(corpus, n_streams: int, width: int, height: int) -> dict:
    """IDCT of a dense tensor of one n_streams step (lane s holds corpus
    s % len(corpus), the frames of the GOP cycled over the lanes) against
    golden_idct_dense, tolerance 0.  Returns the block-class counts."""
    import jax

    from h263_tpu.bitio import BitReader
    from h263_tpu.ops.idct import (golden_classes, golden_idct_dense,
                                   idct_residual_dense_jnp)
    from h263_tpu.parser.frame import parse_frame_auto
    from h263_tpu.parser.picture import decode_picture
    from h263_tpu.types import (DecoderOption, PictureOption,
                                carry_forward_options)

    opts = DecoderOption.SORENSON_SPARK_BITSTREAM
    rows = []
    for frames in corpus:
        prev, running = None, PictureOption.NONE
        for buf in frames:
            r = BitReader(buf)
            pic = decode_picture(r, opts, prev)
            running = carry_forward_options(pic, running)
            rows.append(dense_from_frame(
                parse_frame_auto(r, pic, opts, running, width, height)))
            prev = pic
    dense = np.stack([rows[s % len(rows)] for s in range(n_streams)])
    dense[0, 0] = fma_block()
    cls = golden_classes(dense)
    counts = {int(c): int((cls == c).sum()) for c in range(4)}
    if min(counts.values()) == 0:
        raise AssertionError(f"a block class is missing: {counts}")
    got = jax.jit(idct_residual_dense_jnp)(dense)
    assert_equal("IDCT residuals", got, golden_idct_dense(dense))
    if int(np.asarray(got)[0, 0].reshape(8, 8)[0, 2]) != 28:
        raise AssertionError("adversarial block: FMA contraction")
    return counts


def phase_strict(dev_dec, host_dec, corpus, width: int, height: int):
    import bench

    for name, dec in (("host", host_dec), ("device front-end", dev_dec)):
        bench.verify_strict_rounding(dec, width, height)
        log(f"strict gate ({name}, S={dec.n}): pixel 156")
    counts = idct_parity(corpus, SERVE_STREAMS, width, height)
    log(f"IDCT parity: {SERVE_STREAMS} x {6 * (-(-width // 16)) * (-(-height // 16))}"
        f" blocks, classes {counts}: equal to the golden")


def check_lanes(name, outs, gold, lanes, n_corp):
    """outs[t] = (y, cb, cr) device arrays [S, ...]; gold[c][t] = numpy
    decode of corpus c.  Lane s decodes corpus s % n_corp."""
    for t, (y, cb, cr) in enumerate(outs):
        ys, cbs, crs = (np.asarray(p[np.asarray(lanes)]) for p in (y, cb, cr))
        for i, s in enumerate(lanes):
            gy, gcb, gcr, _ = gold[s % n_corp][t]
            assert_equal(f"{name} lane {s} frame {t} Y", ys[i], gy)
            assert_equal(f"{name} lane {s} frame {t} Cb", cbs[i], gcb)
            assert_equal(f"{name} lane {s} frame {t} Cr", crs[i], gcr)


def phase_host(host_dec, corpus, gold):
    lists = [[corpus[s % len(corpus)][t] for s in range(host_dec.n)]
             for t in range(len(corpus[0]))]
    lanes = sample_lanes(host_dec.n, len(corpus))
    outs = []
    for bufs in lists:
        outs.append(host_dec.decode_step(bufs))
    check_lanes("host", outs, gold, lanes, len(corpus))
    rgba = np.asarray(host_dec.present_rgba(deblock=True)[np.asarray(lanes)])
    for i, s in enumerate(lanes):
        gy, gcb, gcr, q = gold[s % len(corpus)][-1]
        assert_equal(f"host present lane {s}", rgba[i],
                     golden_rgba(gy, gcb, gcr, q, True))
    log(f"host path: {host_dec.n} lanes x {len(lists)} frames; lanes {lanes} "
        f"equal to the numpy decoder, RGBA equal to the golden")
    return outs[-1]


def phase_devfe(dev_dec, corpus, gold, host_last, card):
    import jax
    import jax.numpy as jnp

    from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
    from h263_tpu.types import DecoderOption

    S, F = dev_dec.n, len(corpus[0])
    lists = [[corpus[s % len(corpus)][t] for s in range(S)] for t in range(F)]
    lanes = sample_lanes(S, len(corpus))
    outs, status_bad = [], 0
    for t, bufs in enumerate(lists):
        outs.append(dev_dec.decode_step(bufs))
        status_bad += int((dev_dec.fetch_status() != 0).sum())
    if status_bad:
        raise AssertionError(f"device front-end: {status_bad} lane-frames "
                             f"with nonzero status")
    check_lanes("devfe", outs, gold, lanes, len(corpus))
    n_host = host_last[0].shape[0]
    for p, name in enumerate(("Y", "Cb", "Cr")):
        if not bool(jnp.array_equal(outs[-1][p][:n_host], host_last[p])):
            raise AssertionError(f"devfe != host path on shared lanes ({name})")
    log(f"device front-end: {S} lanes x {F} frames, status all 0; lanes "
        f"{lanes} equal to the numpy decoder; lanes 0..{n_host - 1} equal "
        f"to the host path")

    # One K-frame window through decode_steps against the single steps.
    win = DeviceFrontendDecoder(
        S, dev_dec.w, dev_dec.h, DecoderOption.SORENSON_SPARK_BITSTREAM,
        tape_len=dev_dec.tape_len, max_frame_bytes=dev_dec.max_frame_bytes)
    ys, cbs, crs = win.decode_steps(lists[:MEGASTEP])
    if int((np.asarray(win.last_status_steps) != 0).sum()):
        raise AssertionError("decode_steps window: nonzero lane status")
    for t in range(MEGASTEP):
        for p, w in enumerate((ys, cbs, crs)):
            if not bool(jnp.array_equal(w[t], outs[t][p])):
                raise AssertionError(
                    f"decode_steps K={MEGASTEP} frame {t} plane {p} differs "
                    f"from the single step")
    log(f"decode_steps K={MEGASTEP} window equal to the single steps")
    del win, ys, cbs, crs

    # Rough steady rate: frames 2.. again on a warm decoder.
    y = None
    t0 = time.perf_counter()
    for bufs in lists[2:]:
        y, _, _ = dev_dec.decode_step(bufs)
    y.block_until_ready()
    fps = S * (F - 2) / (time.perf_counter() - t0)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"peak device memory: {peak} bytes")
    log(f"smoke, not a benchmark: device front-end {fps:.0f} frames/s at "
        f"S={S} {dev_dec.w}x{dev_dec.h} ({card})")


def phase_real_content(path: str, lanes: int = 4):
    from h263_tpu.io.flv import iter_flv_video_tags
    from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
    from h263_tpu.types import DecoderOption

    with open(path, "rb") as f:
        tags = [t.payload for t in iter_flv_video_tags(f.read())]
    gold = numpy_decode(tags)
    h, w = gold[0][0].shape
    mbs = (-(-w // 16)) * (-(-h // 16))
    cap = max(8192, -(-max(len(b) for b in tags) // 4096) * 4096)
    dec = DeviceFrontendDecoder(lanes, w, h,
                                DecoderOption.SORENSON_SPARK_BITSTREAM,
                                tape_len=16 * mbs, max_frame_bytes=cap)
    repaired = 0
    for t, buf in enumerate(tags):
        dec.decode_step([buf] * lanes)
        repaired += len(dec.resolve_overflows())
        if int((dec.fetch_status() != 0).sum()):
            raise AssertionError(f"{path} frame {t}: nonzero lane status")
        # Repairs land in the decoder's planes, not in the step's outputs.
        for p, g in zip((dec.ref_y, dec.ref_cb, dec.ref_cr), gold[t][:3]):
            for lane in range(lanes):
                assert_equal(f"{os.path.basename(path)} frame {t} lane "
                             f"{lane}", p[lane], g)
    log(f"{os.path.basename(path)}: {len(tags)} frames {w}x{h} x {lanes} "
        f"lanes equal to the numpy decoder ({repaired} tape-overflow lane "
        f"repairs)")


def phase_pool():
    from h263_tpu.parallel.pool import StreamPool
    from h263_tpu.types import DecoderOption

    gops = {"a": corpora(*QCIF, 1, 10, seed0=300)[0],
            "b": corpora(*QCIF, 1, 10, seed0=301)[0],
            "c": corpora(*QCIF, 1, 10, seed0=302)[0]}
    cif = corpora(*CIF, 1, 6, seed0=303)[0]
    pool = StreamPool(DecoderOption.SORENSON_SPARK_BITSTREAM)
    for sid in ("a", "b"):
        pool.add_stream(sid, *QCIF)
    feed = {"a": list(gops["a"]), "b": list(gops["b"])}
    checked = {"a": [], "b": []}
    for step in range(8):
        if step == 2:
            pool.add_stream("c", *QCIF)                 # join
            feed["c"] = list(gops["c"])
        if step == 4:
            pool.remove_stream("b")                     # leave
            feed.pop("b")
        if step == 5:
            feed["a"] = list(cif)                       # I-frame rebucket
        bufs = {sid: f.pop(0) for sid, f in feed.items()}
        out = pool.decode_step(bufs)
        for sid in ("a", "b"):
            if sid in bufs:
                checked[sid].append((bufs[sid], np.asarray(out[sid][0])))
    for sid, pairs in checked.items():
        gold = numpy_decode([b for b, _ in pairs])
        for t, ((_, y), g) in enumerate(zip(pairs, gold)):
            assert_equal(f"pool stream {sid} step {t}", y, g[0])
    log("serving pool: join, leave and QCIF->CIF rebucket; streams a, b "
        "equal to the numpy decoder")


def phase_soak():
    from tools.soak_hw import run_soak

    for frontend in ("host", "device"):
        counts = run_soak(4, 60, *QCIF, present_every=15, frontend=frontend,
                          log=log)
        if any(counts.values()):
            raise AssertionError(f"soak ({frontend}) mismatches: {counts}")
        log(f"soak ({frontend}): 60 frames x 4 streams, planes and "
            f"{len(counts) - 3} RGBA checks bit-exact")


def phase_four_cards(card, per_card: int = 512, dims=CIF, frames: int = 4,
                     unroll: int = 4):
    import jax

    import __graft_entry__ as ge
    from h263_tpu.decoder.reconstruct import get_present_fn
    from h263_tpu.parallel.batch import BatchedStreamDecoder
    from h263_tpu.types import DecoderOption

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {devices}")
    S = 4 * per_card
    corpus = corpora(*dims, N_CORPORA, frames)
    lists = [[corpus[s % N_CORPORA][t] for s in range(S)]
             for t in range(frames)]
    out = ge.dryrun_multichip(4, *dims, stream_frames=lists, unroll=unroll)

    for name, (fn, args) in out["programs"].items():
        text = fn.lower(*args).compile().as_text()
        found = sorted(set(m.group(1) for m in COLLECTIVES.finditer(text)))
        if found:
            raise AssertionError(f"sharded program {name}: collectives "
                                 f"{found}")
    log(f"compiled HLO of {sorted(out['programs'])}: no collectives")

    one = BatchedStreamDecoder(S, *dims, DecoderOption.SORENSON_SPARK_BITSTREAM)
    for bufs in lists:
        y, cb, cr = one.decode_step(bufs)
    for tag in ("host", "devfe"):
        for p, name in enumerate(("Y", "Cb", "Cr")):
            assert_equal(f"4-card {tag} {name} vs one card",
                         out[tag][p], (y, cb, cr)[p])
    rgba = get_present_fn(dims[1], dims[0])(y, cb, cr, out["strength"],
                                            out["apply"])
    assert_equal("4-card present vs one card", out["rgba"], rgba)
    log(f"four cards: S={S} {dims[0]}x{dims[1]} host + device front-end + "
        f"present planes equal to one card ({card})")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU stream-sharded mesh phase")
    args = ap.parse_args()

    import jax

    from h263_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    timer = Timer()
    card = card_line()
    with timer.phase("0 device"):
        phase_device(card)

    if args.four_cards:
        with timer.phase("7 four cards"):
            phase_four_cards(card)
    else:
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
        from h263_tpu.types import DecoderOption

        W, H = CIF
        mbs = (-(-W // 16)) * (-(-H // 16))
        corpus = corpora(W, H, N_CORPORA, GOP_FRAMES)
        host = BatchedStreamDecoder(
            HOST_STREAMS, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
            pack_cap=10 * mbs, coef_transport="d24")
        dev = DeviceFrontendDecoder(
            SERVE_STREAMS, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
            tape_len=16 * mbs, max_frame_bytes=8192)
        with timer.phase("1 strict gate + IDCT parity"):
            phase_strict(dev, host, corpus, W, H)
        t0 = time.perf_counter()
        gold = [numpy_decode(frames) for frames in corpus]
        log(f"numpy goldens: {N_CORPORA} x {GOP_FRAMES} CIF frames in "
            f"{time.perf_counter() - t0:.1f} s")
        with timer.phase("2 host path"):
            host_last = phase_host(host, corpus, gold)
        with timer.phase("3 device front-end"):
            phase_devfe(dev, corpus, gold, host_last, card)
        del host, dev, host_last
        with timer.phase("4 real-encoder content"):
            phase_real_content(os.path.join(
                ROOT, "tests", "fixtures", "ffmpeg_flv1_motion.flv"))
        with timer.phase("5 serving pool"):
            phase_pool()
        with timer.phase("6 soak"):
            phase_soak()

    log(card)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
