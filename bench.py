"""Benchmark: concurrent CIF Sorenson Spark decode throughput on one device.

Headline metric: DISTINCT per-stream content — each stream decodes its own
corpus, the realistic serving regime.  Two production paths are measured
side by side and the headline is the MAX of the two by worst-pass fps (the
device front-end is promoted only where it actually wins):

  * host path: native host entropy decode -> ONE fused uint8 leaf/step ->
    device reconstruction (parallel/batch.py)
  * device front-end: raw frame bytes -> on-device VLC automaton ->
    reconstruction (parallel/device_batch.py), at the serving shape
    --serve-streams

Correctness gates (strict f32 rounding + device-front-end bit-exactness
vs the host decoder, on tiny shapes) run in this process before any timed
section; a failed gate zeroes the headline and the bench exits 1.

Robustness scaffolding still present (to be replaced by per-cell records):
ONE result record is upgraded in place and re-emitted after EVERY section,
so the last stdout line is always a complete record; every section is
budget-gated (--budget); device readbacks at finalize run in bounded
threads; an in-process deadline thread (--exit-deadline) and two forked
watchdogs (--init-timeout, --overall-timeout) emit the record if the
process hangs.

Stages measured: host entropy decode (both corpus regimes), end-to-end
sequential steps for both paths, device reconstruction in isolation,
presentation (deblock + BT.601 RGBA), 720p through both paths, and a
second CIF sample.

Prints the result as a JSON line:
  {"metric": "cif_decode_frames_per_sec_per_chip", "value": ..., "unit":
   "frames/s", "vs_baseline": value / 30000}
Its detail names the device (platform, device_kind, count, and the card's
name and power limit from nvidia-smi), the compile-cache directory and
XLA_FLAGS.

vs_baseline is against the north-star target of 1000 concurrent real-time
CIF streams per device = 30000 frames/s (BASELINE.json; the reference
publishes no numbers of its own — BASELINE.md).

Flags: --streams N --frames N --width W --height H --json-only
       --corpus shared|distinct --no-720p --budget S --serve-streams N
       --no-gates
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Last-resort init watchdog.  A device that never initialises can block
# INSIDE `import jax` / device init in C code, where no in-process timeout
# (signal or thread) is guaranteed to fire.  A forked
# child shares our stdout: if the parent has not written the sentinel file
# within the timeout, the child prints a zeroed-headline JSON record —
# which becomes the LAST stdout line once it SIGKILLs the parent — so the
# driver's round artifact records the outage instead of hanging forever.
_WATCHDOG_SRC = r"""
import json, os, signal, sys, time
sent, ppid, timeout = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
sidecar = sys.argv[4] if len(sys.argv) > 4 else None
deadline = time.time() + timeout
while time.time() < deadline:
    if os.path.exists(sent):
        sys.exit(0)
    try:
        os.kill(ppid, 0)
    except OSError:
        break  # parent crashed without disarming: record the outage below
    time.sleep(2)
if os.path.exists(sent):
    sys.exit(0)
# Timed out, or the parent died to a raised plugin/XLA error (as real a
# device failure as a hang): either way, end the stream with an
# authoritative JSON record — the replayed sidecar line, or zeroed.
# Mid-run mode: replay the last JSON line the parent managed to emit (the
# crash-safe record) so the driver records real numbers, not silence.
line = None
if sidecar and os.path.exists(sidecar):
    lines = [l for l in open(sidecar).read().splitlines() if l.strip()]
    line = lines[-1] if lines else None
if line is None:
    err, note = (("device_init_timeout", "jax import/device init did not "
                  "complete") if sidecar is None
                 else ("bench_hung", "bench produced no record within the "
                       "overall timeout"))
    line = json.dumps({
        "metric": "cif_decode_frames_per_sec_per_chip",
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "detail": {"error": err, "timeout_s": timeout, "note": note},
    })
print(line, flush=True)
try:
    os.kill(ppid, signal.SIGKILL)
except OSError:
    pass
"""


def _spawn_watchdog(timeout_s: float, sidecar: str = None):
    """Arm a kill-and-report watchdog; returns a callable that disarms it.

    Without `sidecar` (init phase): emits a zeroed record on timeout.
    With `sidecar` (mid-run phase): replays the parent's last emitted JSON
    line — the device can fail mid-compile AFTER init succeeded, which
    would otherwise hang the bench past any numbers it already measured."""
    sentinel = f"/tmp/h263_bench_wd_{os.getpid()}_{timeout_s:.0f}"
    try:
        os.unlink(sentinel)
    except OSError:
        pass
    argv = [sys.executable, "-c", _WATCHDOG_SRC, sentinel, str(os.getpid()),
            str(float(timeout_s))]
    if sidecar is not None:
        argv.append(sidecar)
    # Own session: the driver wraps the bench in GNU `timeout`, which
    # signals the whole process GROUP at expiry — round 3's watchdogs died
    # with the parent and never replayed the record (rc=124, parsed=null).
    # A detached watchdog survives the group kill, notices the parent's
    # death within ~2 s, replays the last emitted JSON line as the final
    # stdout line, and exits.
    child = subprocess.Popen(argv, start_new_session=True)

    def disarm():
        with open(sentinel, "w"):
            pass
        try:
            child.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover
            child.kill()
        try:
            os.unlink(sentinel)
        except OSError:
            pass

    return disarm


def build_corpus(width: int, height: int, n_frames: int, seed: int = 7):
    """One I-frame + P-frames with mixed MVs/coefficients.

    NB: sharing ONE buffer across all streams lets the branch predictor
    memorize the exact symbol sequence and keeps the frame bytes in L1 —
    measured ~1.6x faster host parse than realistic distinct-content
    streams.  The benchmark therefore measures BOTH regimes and headlines
    the distinct one (a pool of corpora cycled over streams)."""
    from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu.types import PictureTypeCode

    rng = np.random.default_rng(seed)
    mbw, mbh = -(-width // 16), -(-height // 16)

    frames = []
    mbs = []
    for _ in range(mbw * mbh):
        dc = int(rng.integers(1, 128)) * 8
        acs = [(int(rng.integers(0, 3)), int(rng.integers(1, 10)))
               for _ in range(int(rng.integers(1, 5)))]
        mbs.append(MBSpec(kind="intra", intradc=[dc] * 6,
                          blocks=[acs, [], [], [], [], []]))
    frames.append(encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME, mbs, temporal_reference=0))

    for tr in range(1, n_frames):
        mbs = []
        for _ in range(mbw * mbh):
            roll = rng.random()
            if roll < 0.2:
                mbs.append(MBSpec(kind="uncoded"))
                continue
            mvd = (int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
            acs = [(int(rng.integers(0, 4)), int(rng.integers(1, 8)))
                   for _ in range(int(rng.integers(0, 4)))]
            mbs.append(MBSpec(kind="inter", mvd=[mvd],
                              blocks=[acs, [], [], [], [], []]))
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME, mbs, temporal_reference=tr & 0xFF))
    return frames


def verify_strict_rounding(dec, width: int, height: int):
    """Assert the device backend performs reference-strict f32 rounding,
    reusing the given (already-constructed) batched decoder — no extra jit
    signatures.

    Decodes a crafted two-frame sequence whose IDCT output flips by one if
    the backend contracts mul+add into FMAs (skipping the product rounding
    the reference performs): dequantized coefficients {735, -555, 215} at
    positions (2,0),(3,0),(2,2) yield residual 28 strict / 27 contracted at
    pixel (0,2).
    """
    from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
    from h263_tpu.types import PictureTypeCode

    nmb = (-(-width // 16)) * (-(-height // 16))
    f0 = encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[1024] * 6)] * nmb,
        temporal_reference=0)
    # quant 5: levels 73, -55, 21 dequantize to exactly 735, -555, 215.
    f1 = encode_sorenson_picture(
        width, height, PictureTypeCode.P_FRAME,
        [MBSpec(kind="inter", mvd=[(0, 0)],
                blocks=[[(5, 73), (0, -55), (5, 21)], [], [], [], [], []])]
        + [MBSpec(kind="uncoded")] * (nmb - 1),
        quantizer=5, temporal_reference=1)

    dec.decode_step([f0] * dec.n)
    y, _, _ = dec.decode_step([f1] * dec.n)
    # Fetch ONE device-sliced scalar, not the whole batch plane.
    got = int(np.asarray(y[0, 0, 2]))
    assert got == 128 + 28, (
        f"device backend is not reference-strict: pixel = {got}, expected "
        f"156 (strict) — 155 indicates FMA contraction")


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or ""
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def device_record() -> dict:
    """The device every number of this run was measured on."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "name_power_limit": gpu_name_and_power_limit()}


def stage_summary():
    """Mean/max ms for the decode_step stages since the last reset."""
    from h263_tpu.utils import trace

    m = trace.get_metrics()
    out = {}
    for k in ("host_parse", "transfer", "reconstruct_dispatch",
              "bucket_slice", "reclaim_wait"):
        if k in m:
            out[k] = {"mean_ms": m[k]["mean_ms"], "max_ms": m[k]["max_ms"]}
    trace.reset_metrics()
    return out


def measure_e2e(dec, frame_lists, budget_left, passes=3, window=0):
    """Warm pass (untimed, steady-state) + up to `passes` timed passes over
    frames 2..F; returns (best_fps, worst_fps, stages_best, stages_worst).

    Stage summaries are captured PER PASS and the summaries of the best
    and worst passes are returned separately (a worst-pass
    outlier must be attributable to transfer vs dispatch vs prep from the
    record alone, not inferred from a best-pass mean).

    window > 0: decode through decode_steps in windows of `window` frames
    (the K-frame megastep — one device dispatch and one transfer leaf per
    K frames, amortizing the per-call host RPC floor that bounds the
    serving shape).  Frames 2..F are trimmed to a multiple of `window` so
    every pass replays the same (T, payload-rung) program shapes.
    """
    from h263_tpu.utils import trace

    S = dec.n
    F = len(frame_lists)
    if window:
        usable = ((F - 2) // window) * window
        if usable == 0:
            raise ValueError(
                f"megastep window {window} needs >= {window + 2} frames, "
                f"corpus has {F}")
        wins = [frame_lists[2 + k * window: 2 + (k + 1) * window]
                for k in range(usable // window)]

        def one_pass():
            for wlists in wins:
                ys, _, _ = dec.decode_steps(wlists)
            ys.block_until_ready()
            return S * usable

        # Seed the reference planes (I-frame rides in the first window)
        # and compile the T-frame program + the I-window's payload rung.
        ys, _, _ = dec.decode_steps(frame_lists[:window])
        ys.block_until_ready()
    else:
        def one_pass():
            for t in range(2, F):
                y, _, _ = dec.decode_step(frame_lists[t])
            y.block_until_ready()
            return S * (F - 2)

        y, _, _ = dec.decode_step(frame_lists[0])
        y, _, _ = dec.decode_step(frame_lists[1])
        y.block_until_ready()
    # Steady-state warm pass: first-pass effects (icache/predictor warmup,
    # CPU frequency ramp, lazily-bound buffers) measured ~15-40% slower
    # than steady state; serving throughput is the steady-state number.
    one_pass()
    best, worst = 0.0, float("inf")
    stages_best = stages_worst = None
    t_end = time.perf_counter() + budget_left
    for rep in range(passes):
        if rep and time.perf_counter() > t_end:
            break
        trace.reset_metrics()
        t0 = time.perf_counter()
        n_frames = one_pass()
        fps = n_frames / (time.perf_counter() - t0)
        st = stage_summary()
        if fps > best:
            best, stages_best = fps, st
        if fps < worst:
            worst, stages_worst = fps, st
    return best, worst, stages_best, stages_worst


# ---------------------------------------------------------------------------
# Correctness gates
# ---------------------------------------------------------------------------

def run_gates() -> dict:
    """The correctness gates, run in this process before any timed section
    on tiny shapes; returns the verdict (``ok`` is True only if all pass).

    Gates:
      * strict f32 rounding through the production fused-transport host
        path + reconstruction (the FMA-contraction hazard the reference's
        sequential accumulation defines, h263/src/decoder/cpu/idct.rs).
      * device front-end bit-exactness: an 8-frame GOP decoded through
        both front-ends must produce identical planes and all-ok lane
        status.
      * the same for every corpus of the distinct-content pool, at the
        16/MB tape budget the serve sections use (tape need is per-MB, so
        the QCIF check carries over to CIF).  A silently-errored lane
        decodes a cheap identity frame, which would inflate serve numbers.
    """
    import jax
    import jax.numpy as jnp

    from h263_tpu.parallel.batch import BatchedStreamDecoder
    from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
    from h263_tpu.types import DecoderOption

    t0 = time.perf_counter()
    W, H, S, F = 176, 144, 4, 8
    nmb = (-(-W // 16)) * (-(-H // 16))
    report = {"ok": False, "streams": S, "backend": jax.default_backend()}
    if (report["backend"] == "cpu"
            and "xla_disable_hlo_passes" not in os.environ.get("XLA_FLAGS", "")):
        # Mirrors tests/conftest.py: XLA:CPU's fusion emitter FMA-contracts
        # f32 mul+add, so on the CPU the gates test XLA, not the decoder.
        report["note"] = ("cpu backend without fusion-pass disable: "
                          "gates test XLA:CPU fusion, not the decoder")

    def decoders():
        return (BatchedStreamDecoder(
                    S, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
                    pack_cap=10 * nmb, coef_transport="d24"),
                DeviceFrontendDecoder(
                    S, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
                    tape_len=16 * nmb, max_frame_bytes=8192))

    def same(a, b):
        return all(bool(jnp.array_equal(x, y)) for x, y in zip(a, b))

    corpus = build_corpus(W, H, F, seed=31)
    dec, dfe = decoders()
    report["payload_layout"] = dfe.payload
    for t in range(F):
        host = dec.decode_step([corpus[t]] * S)
        dev = dfe.decode_step([corpus[t]] * S)
    report["devfe_match"] = "ok" if same(host, dev) else "FAILED"
    report["devfe_status_ok"] = int((dfe.fetch_status() == 0).sum())

    bad_groups, bad_lanes = [], 0
    n_corp = 24
    dist = [build_corpus(W, H, F, seed=100 + c) for c in range(n_corp)]
    for g in range(0, n_corp, S):
        group = dist[g:g + S]
        dh, dv = decoders()
        for t in range(F):
            host = dh.decode_step([group[s][t] for s in range(S)])
            dev = dv.decode_step([group[s][t] for s in range(S)])
        if not same(host, dev):
            bad_groups.append(g)
        bad_lanes += int((dv.fetch_status() != 0).sum())
    report["devfe_distinct_bad_lanes"] = bad_lanes
    report["devfe_distinct_match"] = (
        "ok" if not bad_groups and bad_lanes == 0
        else f"FAILED: groups {bad_groups}, {bad_lanes} errored lanes")

    try:
        verify_strict_rounding(dec, W, H)
        report["strict_rounding"] = "ok"
    except AssertionError as e:
        report["strict_rounding"] = f"FAILED: {e}"
    report["ok"] = (report["strict_rounding"] == "ok"
                    and report["devfe_match"] == "ok"
                    and report["devfe_status_ok"] == S
                    and report["devfe_distinct_match"] == "ok")
    report["wall_s"] = round(time.perf_counter() - t0, 1)
    return report


def main():
    bench_t0 = time.perf_counter()
    import threading

    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=352)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--pack-per-mb", type=int, default=10,
                    help="packed-transport capacity in coefficients per "
                         "macroblock (smaller = fewer transfer bytes; "
                         "overflow falls back to the dense transport)")
    ap.add_argument("--transport", default="d24", choices=["u32", "d24"],
                    help="packed coefficient transport: delta-coded 3 B "
                         "(d24, default; ships fused with MVs+flags as ONE "
                         "transfer leaf) or combined-u32 4 B")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--corpus", default="distinct",
                    choices=["shared", "distinct"],
                    help="headline corpus: 'distinct' (per-stream content — "
                         "realistic serving, the default) or 'shared' (one "
                         "buffer for all streams — predictor-warm, ~1.3-"
                         "1.6x optimistic on the host stage).  Both regimes "
                         "are measured and reported either way")
    ap.add_argument("--distinct-corpora", type=int, default=24,
                    help="number of distinct stream corpora cycled over "
                         "the batch for the distinct-content measurements")
    ap.add_argument("--serve-streams", type=int, default=2048,
                    help="batch size for the device-front-end serving "
                         "shape.  0 skips the section")
    ap.add_argument("--megastep", type=int, default=8,
                    help="K-frame megastep window for the device-front-end "
                         "serving shape (decode_steps: one transfer leaf + "
                         "one dispatch per K frames, amortizing the per-call "
                         "host floor).  0 skips the megastep section")
    ap.add_argument("--no-720p", action="store_true",
                    help="skip the 720p secondary measurement")
    ap.add_argument("--budget", type=float, default=1100.0,
                    help="soft wall-clock budget (s); compile-bearing "
                         "sections are skipped once the remaining budget "
                         "cannot absorb a worst-case compile")
    ap.add_argument("--exit-deadline", type=float, default=1560.0,
                    help="hard in-process deadline (s): a daemon thread "
                         "emits the current record and os._exit(0)s at "
                         "this wall time even if the main thread is wedged "
                         "in a C-level device call.  Works whenever the "
                         "wedged call releases the GIL; the forked "
                         "--overall-timeout watchdog remains the last "
                         "resort when it doesn't.  <=0 disables")
    ap.add_argument("--init-timeout", type=float, default=600.0,
                    help="hard bound (s) on jax import + device discovery; "
                         "if exceeded (device down) a zeroed JSON "
                         "record is emitted and the bench aborts instead "
                         "of hanging.  <=0 disables the watchdog")
    ap.add_argument("--overall-timeout", type=float, default=2400.0,
                    help="hard bound (s) on the whole bench after init; on "
                         "expiry the last emitted JSON line (a complete "
                         "record) is replayed and the process is killed — "
                         "covers the device failing mid-compile.  <=0 disables")
    ap.add_argument("--no-gates", action="store_true",
                    help="skip the correctness gates (testing)")
    args = ap.parse_args()

    disarm_watchdog = (_spawn_watchdog(args.init_timeout)
                       if args.init_timeout > 0 else (lambda: None))

    import jax

    from h263_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    jax.devices()  # force platform init under the watchdog
    disarm_watchdog()
    sidecar = f"/tmp/h263_bench_last_{os.getpid()}.json"
    try:
        os.unlink(sidecar)
    except OSError:
        pass
    disarm_overall = (_spawn_watchdog(args.overall_timeout, sidecar)
                      if args.overall_timeout > 0 else (lambda: None))

    from h263_tpu.parallel.batch import BatchedStreamDecoder
    from h263_tpu.types import DecoderOption
    from h263_tpu.utils import trace

    trace.trace_enabled(True)

    log = (lambda *a: None) if args.json_only else (
        lambda *a: print(*a, file=sys.stderr))

    def budget_left():
        return args.budget - (time.perf_counter() - bench_t0)

    log(f"devices: {jax.devices()}")
    S, F, W, H = args.streams, args.frames, args.width, args.height
    mbs_per_frame = (-(-W // 16)) * (-(-H // 16))

    # ---- the ONE record, upgraded in place and emitted after every section
    result = {
        "metric": "cif_decode_frames_per_sec_per_chip",
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "detail": {
            "headline_regime": args.corpus,
            "headline_path": None,
            "sections_completed": [],
            "host_parse_fps_per_core": None,
            "host_parse_distinct_fps_per_core": None,
            "end_to_end_shared_fps": None,
            "end_to_end_shared_worst_fps": None,
            "end_to_end_distinct_fps": None,
            "end_to_end_distinct_worst_fps": None,
            "end_to_end_worst_fps": None,
            "end_to_end_pipelined_diagnostic_fps": None,
            "device_stage_fps": None,
            "present_rgba_fps": None,
            "devfe_serve": None,
            "device_frontend_validation": "pending",
            "stages_ms_shared": None,
            "stages_ms_distinct": None,
            "p720": None,
            "gates": None,
            "device": device_record(),
            "compile_cache_dir": cache_dir,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "strict_rounding": "pending",
            "transport": args.transport,
            "fused_transport": None,
            "native_frontend": None,
            "streams": S, "frames": F, "width": W, "height": H,
            "serve_streams": args.serve_streams,
            "elapsed_s": None,
            "baseline_note": ("vs north-star 1000 real-time CIF streams/"
                              "chip (30000 f/s); reference publishes no "
                              "numbers"),
        },
    }
    detail = result["detail"]

    _emit_lock = threading.Lock()

    def emit(section=None):
        if section:
            detail["sections_completed"].append(section)
        detail["elapsed_s"] = round(time.perf_counter() - bench_t0, 1)
        line = json.dumps(result)
        with _emit_lock:
            with open(sidecar, "a") as f:
                f.write(line + "\n")
            print(line, flush=True)

    # Hard in-process deadline: if the main
    # thread is wedged in a C-level device call at the deadline, this
    # daemon thread emits the current (complete, final-format) record as
    # the last stdout line and exits 0.  Device waits release the GIL,
    # so the thread runs even mid-wedge; a GIL-holding wedge falls through
    # to the forked SIGKILL watchdog.
    def _deadline_exit():
        delay = args.exit_deadline - (time.perf_counter() - bench_t0)
        if delay > 0:
            time.sleep(delay)
        try:
            detail["sections_completed"].append("deadline_exit")
            emit()
        except Exception:  # pragma: no cover
            pass
        os._exit(0)

    if args.exit_deadline > 0:
        threading.Thread(target=_deadline_exit, daemon=True).start()

    _wedged = {"flag": False}

    def bounded_device(fn, timeout_s, label):
        """Run a device interaction in a daemon thread with a deadline;
        returns (value, None) or (None, reason).  The first timeout marks
        the device wedged and every later interaction is skipped — a
        wedged call holds the runtime's dispatch path, so piling more
        threads onto it only wedges them too."""
        if _wedged["flag"]:
            return None, "skipped (device wedged)"
        out = {}

        def run():
            try:
                out["v"] = fn()
            except Exception as e:  # pragma: no cover
                out["e"] = repr(e)[:200]

        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(timeout_s)
        if th.is_alive():
            _wedged["flag"] = True
            log(f"{label}: no result within {timeout_s:.0f}s -> device "
                f"marked wedged; skipping remaining device interactions")
            return None, f"timeout>{timeout_s:.0f}s"
        if "e" in out:
            return None, out["e"]
        return out.get("v", True), None

    # The driver bounds the bench with GNU `timeout` (SIGTERM).  If it
    # fires while Python bytecode is running, emit the current record as
    # the last stdout line and leave cleanly; if the process is wedged in
    # a C-level device compile, the handler can't run and the detached
    # mid-run watchdog replays the sidecar instead.
    import signal as _signal

    def _on_term(signum, frame):  # pragma: no cover - driver-kill path
        detail.setdefault("sections_completed", []).append("sigterm")
        emit()
        os._exit(0)

    _signal.signal(_signal.SIGTERM, _on_term)

    # Headline bookkeeping: candidate paths, each (best_fps, worst_fps).
    paths = {}

    def refresh_headline():
        """Headline = the path with the best WORST-pass fps (tie: best)."""
        if not paths:
            return
        name, (best, worst) = max(
            paths.items(), key=lambda kv: (kv[1][1], kv[1][0]))
        result["value"] = round(best, 1)
        result["vs_baseline"] = round(best / 30000.0, 4)
        detail["headline_path"] = name
        detail["end_to_end_worst_fps"] = round(worst, 1)

    # ---- corpora ----------------------------------------------------------
    t0 = time.perf_counter()
    corpus = build_corpus(W, H, F)
    log(f"corpus: {F} frames encoded in {time.perf_counter() - t0:.2f}s "
        f"({sum(len(b) for b in corpus)} bytes)")
    t0 = time.perf_counter()
    n_corp = max(2, args.distinct_corpora)
    distinct = [build_corpus(W, H, F, seed=100 + c) for c in range(n_corp)]
    log(f"distinct corpora: {n_corp} encoded in "
        f"{time.perf_counter() - t0:.2f}s")

    shared_lists = [[corpus[t]] * S for t in range(F)]
    dist_lists = [[distinct[s % n_corp][t] for s in range(S)]
                  for t in range(F)]

    from h263_tpu.native import ensure_built

    native = ensure_built()
    log(f"native front-end: {native}")
    detail["native_frontend"] = bool(native)
    emit("init")

    # ---- correctness gates (tiny shapes, before any timed section) -------
    if not args.no_gates:
        g = run_gates()
        detail["gates"] = g
        detail["strict_rounding"] = g["strict_rounding"]
        detail["device_frontend_validation"] = (
            "ok" if (g["devfe_match"] == "ok"
                     and g["devfe_status_ok"] == g["streams"]
                     and g["devfe_distinct_match"] == "ok")
            else "FAILED")
        log(f"gates: {g}")
        emit("gates")

    # ---- section A: host path, both CIF regimes ---------------------------
    dec = None
    seq_fps = seq_worst = seq_distinct_fps = seq_distinct_worst = None
    try:
        dec = BatchedStreamDecoder(
            S, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
            pack_cap=args.pack_per_mb * mbs_per_frame,
            coef_transport=args.transport)
        detail["fused_transport"] = bool(dec._fused_enabled)
        log(f"coefficient transport: {args.transport} "
            f"(fused single-leaf: {dec._fused_enabled})")

        host_probe = BatchedStreamDecoder(
            S, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
            pack_cap=args.pack_per_mb * mbs_per_frame,
            coef_transport=args.transport)
        pk = host_probe.next_packed_batch()

        def probe(lists):
            # Full warm pass first: first-walk effects (predictor/icache/
            # CPU frequency) measured 15-40% slower than steady state.
            for t in range(F):
                host_probe.parse_batch_packed(lists[t], pk)
            best = 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                for t in range(1, F):
                    host_probe.parse_batch_packed(lists[t], pk)
                best = max(best, S * (F - 1) / (time.perf_counter() - t0))
            return best

        # Each regime's probe runs immediately before its end-to-end
        # section: the box's throughput drifts between minutes, and
        # separating them produced artifacts where the parse-only rate read
        # BELOW the e2e rate (different windows).
        trace.reset_metrics()
        host_fps = probe(shared_lists)
        detail["host_parse_fps_per_core"] = round(host_fps, 1)
        log(f"host entropy decode: {host_fps:.1f} frames/s/core "
            f"(best of 3 passes, shared corpus)")
        seq_fps, seq_worst, stages_shared, stages_shared_w = measure_e2e(
            dec, shared_lists, budget_left())
        detail["end_to_end_shared_fps"] = round(seq_fps, 1)
        detail["end_to_end_shared_worst_fps"] = round(seq_worst, 1)
        detail["stages_ms_shared"] = stages_shared
        detail["stages_ms_shared_worst"] = stages_shared_w
        log(f"end-to-end sequential: {seq_fps:.1f} frames/s/chip "
            f"(batch={S}, shared corpus, best of 3; worst {seq_worst:.1f})")
        log(f"  stages: { {k: v['mean_ms'] for k, v in stages_shared.items()} }")

        host_distinct_fps = probe(dist_lists)
        detail["host_parse_distinct_fps_per_core"] = round(
            host_distinct_fps, 1)
        log(f"host entropy decode: {host_distinct_fps:.1f} frames/s/core "
            f"(best of 3 passes, DISTINCT per-stream content)")
        (seq_distinct_fps, seq_distinct_worst, stages_distinct,
         stages_distinct_w) = measure_e2e(dec, dist_lists, budget_left())
        detail["end_to_end_distinct_fps"] = round(seq_distinct_fps, 1)
        detail["end_to_end_distinct_worst_fps"] = round(
            seq_distinct_worst, 1)
        detail["stages_ms_distinct"] = stages_distinct
        detail["stages_ms_distinct_worst"] = stages_distinct_w
        log(f"end-to-end sequential: {seq_distinct_fps:.1f} frames/s/chip "
            f"(DISTINCT content, best of 3; worst {seq_distinct_worst:.1f})")
        log(f"  stages: { {k: v['mean_ms'] for k, v in stages_distinct.items()} }")

        paths["host"] = ((seq_distinct_fps, seq_distinct_worst)
                         if args.corpus == "distinct"
                         else (seq_fps, seq_worst))
        refresh_headline()
    except Exception as e:  # pragma: no cover
        log(f"host-path section failed: {e!r}")
        detail["host_path_error"] = repr(e)[:200]
    emit("host_cif")

    # ---- section A2: cheap host-path diagnostics (no new big compiles) ----
    if dec is not None and budget_left() > 60:
        try:
            # Pipelined mode: diagnostic only — with one host core the
            # transfer's CPU work just time-slices against the parse
            # (tools/prof_pipeline.py).
            y, _, _ = dec.decode_step(shared_lists[0])
            y, _, _ = dec.decode_step(shared_lists[1])
            y.block_until_ready()
            t0 = time.perf_counter()
            last = None
            for last in dec.decode_stream_pipelined(
                    shared_lists[1 + (t % (F - 1))] for t in range(2 * F)):
                pass
            last[0].block_until_ready()
            pipe_dt = time.perf_counter() - t0
            pipe_fps = S * 2 * F / pipe_dt
            detail["end_to_end_pipelined_diagnostic_fps"] = round(pipe_fps, 1)
            log(f"end-to-end pipelined (diagnostic): {pipe_fps:.1f} "
                f"frames/s/chip ({1e3 * pipe_dt / (2 * F):.2f} ms/step)")
            trace.reset_metrics()

            # Device stage in isolation (packed transfer + reconstruct).
            packed = dec._packed[dec._packed_idx]
            y, cb, cr = dec.step_packed(packed)
            y.block_until_ready()
            reps = max(F - 1, 4)
            device_fps = 0.0
            for rep in range(3):
                if rep and budget_left() < 0:
                    break
                t0 = time.perf_counter()
                for _ in range(reps):
                    y, cb, cr = dec.step_packed(packed)
                y.block_until_ready()
                device_fps = max(device_fps,
                                 S * reps / (time.perf_counter() - t0))
            detail["device_stage_fps"] = round(device_fps, 1)
            log(f"device stage (packed transfer+compute): {device_fps:.1f} "
                f"frames/s/chip (best of 3 passes)")
        except Exception as e:  # pragma: no cover
            log(f"host-path diagnostics failed: {e!r}")
        emit("host_diagnostics")

    # ---- section A3: presentation (deblock + BT.601 RGBA) ------------------
    # One new compile; not part of the headline decode metric.
    if dec is not None and budget_left() > 240:
        try:
            rgba = dec.present_rgba(deblock=True)
            rgba.block_until_ready()
            reps_p = 8
            t0 = time.perf_counter()
            for _ in range(reps_p):
                rgba = dec.present_rgba(deblock=True)
            rgba.block_until_ready()
            present_dt = time.perf_counter() - t0
            present_fps = S * reps_p / present_dt
            detail["present_rgba_fps"] = round(present_fps, 1)
            log(f"present (deblock+RGBA): {present_fps:.1f} frames/s/chip "
                f"({1e3 * present_dt / reps_p:.2f} ms/step)")
        except Exception as e:  # pragma: no cover
            log(f"present measurement skipped: {e!r}")
        emit("present")

    # ---- section B: device front-end at the serving shape ------------------
    # Raw frame bytes ship to the device (the smallest possible transport)
    # and the VLC automaton decodes all streams as lockstep vector lanes
    # (parser/device_frontend.py).  Hardware-validated bit-exact
    # (tools/soak_hw.py --frontend device); the gate child re-validates
    # every run.  Compute-isolated cost is ~flat in S
    # (not yet measured on the GPU), so the serving shape is the
    # largest batch the content mix sustains.
    dfe_serve = None
    serve_status = None
    serve_status_steps = None
    S_serve = args.serve_streams
    if S_serve > 0 and budget_left() > 300:
        try:
            from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

            serve_lists = [[distinct[s % n_corp][t] for s in range(S_serve)]
                           for t in range(F)]
            # Tape budget: the corpus I-frame costs ~9.5 automaton
            # iterations per MB (1 header + 6 INTRADC + 1-4 ACs); 16
            # clears it with margin.
            dfe_serve = DeviceFrontendDecoder(
                S_serve, W, H, DecoderOption.SORENSON_SPARK_BITSTREAM,
                tape_len=16 * mbs_per_frame,
                max_frame_bytes=8192, harness="xla")
            best_s, worst_s, stages_s, stages_s_w = measure_e2e(
                dfe_serve, serve_lists, budget_left())
            detail["devfe_serve"] = {
                "streams": S_serve,
                "payload_layout": dfe_serve.payload,
                "end_to_end_distinct_fps": round(best_s, 1),
                "end_to_end_distinct_worst_fps": round(worst_s, 1),
                "stages_ms": stages_s,
                "stages_ms_worst": stages_s_w,
            }
            paths["devfe_serve"] = (best_s, worst_s)
            refresh_headline()
            log(f"device front-end e2e: {best_s:.1f} frames/s/chip "
                f"distinct (serving shape S={S_serve}, worst {worst_s:.1f}, "
                f"payload={dfe_serve.payload})")
            # Keep only the tiny per-lane status array for the end-of-run
            # check; the serve lists stay (second sample reuses them).
            serve_status = dfe_serve.last_status
        except Exception as e:  # pragma: no cover
            log(f"device front-end serving shape failed: {e!r}")
            detail["devfe_serve"] = {"error": repr(e)[:200]}
            dfe_serve = None
        emit("devfe_serve")

        # K-frame megastep: same decoder, but decode_steps
        # ships K frames in ONE transfer leaf and runs K automaton frames
        # per dispatch — the single-frame serve step is host-RPC-floor-
        # bound (prep + transfer RPC + dispatch RPC, all host-side), so
        # the megastep amortizes that floor K ways and exposes the
        # device automaton as the bound instead.
        if dfe_serve is not None and args.megastep > 0 and budget_left() > 180:
            try:
                best_m, worst_m, stages_m, stages_m_w = measure_e2e(
                    dfe_serve, serve_lists, budget_left(),
                    window=args.megastep)
                detail["devfe_serve"]["megastep"] = {
                    "window": args.megastep,
                    "end_to_end_distinct_fps": round(best_m, 1),
                    "end_to_end_distinct_worst_fps": round(worst_m, 1),
                    "stages_ms": stages_m,
                    "stages_ms_worst": stages_m_w,
                }
                paths["devfe_megastep"] = (best_m, worst_m)
                refresh_headline()
                log(f"device front-end megastep e2e: {best_m:.1f} frames/s/"
                    f"chip distinct (K={args.megastep}, worst {worst_m:.1f})")
                serve_status_steps = dfe_serve.last_status_steps
            except Exception as e:  # pragma: no cover
                log(f"megastep section failed: {e!r}")
                detail["devfe_serve"]["megastep"] = {"error": repr(e)[:200]}
            emit("devfe_megastep")
    else:
        log("device front-end serving section skipped "
            f"(serve_streams={S_serve}, budget_left={budget_left():.0f})")

    # ---- section C: 720p through both paths -------------------------------
    dfe7_status = None
    if not args.no_720p and budget_left() > 300:
        p720 = {}
        try:
            # 16 frames so the K=8 megastep window has a full usable
            # window after the 2 seed frames (measure_e2e trims to a
            # multiple of K).
            W7, H7, S7, F7 = 1280, 720, 64, 16
            t0 = time.perf_counter()
            corp7 = [build_corpus(W7, H7, F7, seed=70 + c) for c in range(4)]
            lists7 = [[corp7[s % 4][t] for s in range(S7)] for t in range(F7)]
            log(f"720p corpora encoded in {time.perf_counter() - t0:.1f}s")
            mbs7 = (-(-W7 // 16)) * (-(-H7 // 16))
            dec7 = BatchedStreamDecoder(
                S7, W7, H7, DecoderOption.SORENSON_SPARK_BITSTREAM,
                pack_cap=args.pack_per_mb * mbs7,
                coef_transport="d24")
            best7, worst7, stages7, stages7w = measure_e2e(
                dec7, lists7, budget_left())
            p720["host"] = {
                "end_to_end_distinct_fps": round(best7, 1),
                "end_to_end_distinct_worst_fps": round(worst7, 1),
                "realtime_streams_distinct": round(best7 / 30.0, 1),
                "stages_ms": stages7, "stages_ms_worst": stages7w}
            p720["streams"] = S7
            detail["p720"] = p720
            log(f"720p host-path e2e: {best7:.1f} frames/s/chip distinct "
                f"(worst {worst7:.1f}; = {best7 / 30.0:.0f} real-time "
                f"streams)")
            del dec7  # free HBM before the devfe 720p program compiles
            emit("p720_host")
        except Exception as e:  # pragma: no cover
            log(f"720p host measurement skipped: {e!r}")
            p720["host"] = {"error": repr(e)[:200]}
            detail["p720"] = p720
        # 720p through the device front-end: the host parse is ~10x worse
        # at 720p (396 -> 3600 MBs/frame), so the automaton's win should
        # be LARGEST here.  Tape and payload cap sized for 720p frames.
        if budget_left() > 300 and "error" not in p720.get("host", {}):
            try:
                from h263_tpu.parallel.device_batch import (
                    DeviceFrontendDecoder,
                )

                # The devfe serves a LARGER batch than the host path, so
                # the per-dispatch host floor amortizes over 4x the
                # streams.
                S7D = 256
                lists7d = [[corp7[s % 4][t] for s in range(S7D)]
                           for t in range(F7)]
                maxb = max(len(b) for corp in corp7 for b in corp)
                cap7 = max(8192, ((maxb + 4095) // 4096) * 4096)
                dfe7 = DeviceFrontendDecoder(
                    S7D, W7, H7, DecoderOption.SORENSON_SPARK_BITSTREAM,
                    tape_len=16 * mbs7,
                    max_frame_bytes=cap7, harness="xla")
                best7d, worst7d, stages7d, stages7dw = measure_e2e(
                    dfe7, lists7d, budget_left())
                p720["devfe"] = {
                    "streams": S7D,
                    "end_to_end_distinct_fps": round(best7d, 1),
                    "end_to_end_distinct_worst_fps": round(worst7d, 1),
                    "realtime_streams_distinct": round(best7d / 30.0, 1),
                    "payload_layout": dfe7.payload,
                    "max_frame_bytes": cap7,
                    "stages_ms": stages7d, "stages_ms_worst": stages7dw}
                log(f"720p devfe e2e: {best7d:.1f} frames/s/chip distinct "
                    f"(worst {worst7d:.1f}; = {best7d / 30.0:.0f} real-time "
                    f"streams)")
                if args.megastep > 0 and budget_left() > 120:
                    try:
                        b7m, w7m, st7m, st7mw = measure_e2e(
                            dfe7, lists7d, budget_left(),
                            window=args.megastep)
                        p720["devfe"]["megastep"] = {
                            "window": args.megastep,
                            "end_to_end_distinct_fps": round(b7m, 1),
                            "end_to_end_distinct_worst_fps": round(w7m, 1),
                            "realtime_streams_distinct": round(b7m / 30.0, 1),
                            "stages_ms": st7m, "stages_ms_worst": st7mw}
                        log(f"720p devfe megastep e2e: {b7m:.1f} frames/s/"
                            f"chip (worst {w7m:.1f}; = {b7m / 30.0:.0f} "
                            f"real-time streams)")
                    except Exception as e:  # pragma: no cover
                        log(f"720p megastep skipped: {e!r}")
                        p720["devfe"]["megastep"] = {"error": repr(e)[:200]}
                # Keep only the tiny per-lane status array for the
                # finalize readback; free the decoder's HBM now.
                dfe7_status = dfe7.last_status
                del dfe7
            except Exception as e:  # pragma: no cover
                log(f"720p devfe measurement skipped: {e!r}")
                p720["devfe"] = {"error": repr(e)[:200]}
        emit("p720")
    elif not args.no_720p:
        log("720p measurement skipped: budget exhausted")

    # ---- section D: second CIF sample, minutes after the first -------------
    # The host's throughput can drift in multi-minute windows.  Folding rule: each sample is one window; the
    # reported worst is the HEALTHIEST window's internal worst (max over
    # samples of the per-sample worst).  A min over all passes would let
    # one transient noisy-neighbor window permanently define the round's
    # worst even after a later sample proves the box recovered.  All
    # sample pairs stay in the detail so nothing is hidden.
    if dec is not None and seq_fps is not None and budget_left() > 45:
        try:
            s2_best, s2_worst, _, s2_stw = measure_e2e(dec, shared_lists,
                                                       budget_left())
            d2_best, d2_worst, _, d2_stw = measure_e2e(dec, dist_lists,
                                                       budget_left())
            # Worst-pass attribution: the recorded
            # diagnostic follows the globally WORST pass seen, whichever
            # sample produced it.
            if s2_worst < seq_worst:
                detail["stages_ms_shared_worst"] = s2_stw
            if d2_worst < seq_distinct_worst:
                detail["stages_ms_distinct_worst"] = d2_stw
            log(f"second sample: shared {s2_best:.1f} (worst {s2_worst:.1f}"
                f"), distinct {d2_best:.1f} (worst {d2_worst:.1f}) "
                f"frames/s/chip")
            pairs = {
                "shared": [[round(seq_fps, 1), round(seq_worst, 1)],
                           [round(s2_best, 1), round(s2_worst, 1)]],
                "distinct": [[round(seq_distinct_fps, 1),
                              round(seq_distinct_worst, 1)],
                             [round(d2_best, 1), round(d2_worst, 1)]],
            }
            seq_fps = max(seq_fps, s2_best)
            seq_worst = max(seq_worst, s2_worst)
            seq_distinct_fps = max(seq_distinct_fps, d2_best)
            seq_distinct_worst = max(seq_distinct_worst, d2_worst)
            detail["end_to_end_shared_fps"] = round(seq_fps, 1)
            detail["end_to_end_shared_worst_fps"] = round(seq_worst, 1)
            detail["end_to_end_distinct_fps"] = round(seq_distinct_fps, 1)
            detail["end_to_end_distinct_worst_fps"] = round(
                seq_distinct_worst, 1)
            paths["host"] = ((seq_distinct_fps, seq_distinct_worst)
                             if args.corpus == "distinct"
                             else (seq_fps, seq_worst))
            # Devfe serve second sample (cheap: everything is compiled).
            if dfe_serve is not None and budget_left() > 20:
                sv2_best, sv2_worst, _, sv2_stw = measure_e2e(
                    dfe_serve, serve_lists, budget_left())
                log(f"second sample devfe serve: {sv2_best:.1f} (worst "
                    f"{sv2_worst:.1f}) frames/s/chip")
                pairs["devfe_serve"] = [
                    [detail["devfe_serve"]["end_to_end_distinct_fps"],
                     detail["devfe_serve"]["end_to_end_distinct_worst_fps"]],
                    [round(sv2_best, 1), round(sv2_worst, 1)]]
                b0, w0 = paths["devfe_serve"]
                if sv2_worst < w0:
                    detail["devfe_serve"]["stages_ms_worst"] = sv2_stw
                paths["devfe_serve"] = (max(b0, sv2_best),
                                        max(w0, sv2_worst))
                detail["devfe_serve"]["end_to_end_distinct_fps"] = round(
                    paths["devfe_serve"][0], 1)
                detail["devfe_serve"]["end_to_end_distinct_worst_fps"] = (
                    round(paths["devfe_serve"][1], 1))
                serve_status = dfe_serve.last_status
                # Megastep second sample (compiled; one warm + timed pass).
                if ("megastep" in detail.get("devfe_serve", {})
                        and "error" not in detail["devfe_serve"]["megastep"]
                        and budget_left() > 20):
                    m2_best, m2_worst, _, m2_stw = measure_e2e(
                        dfe_serve, serve_lists, budget_left(),
                        window=args.megastep)
                    log(f"second sample devfe megastep: {m2_best:.1f} "
                        f"(worst {m2_worst:.1f}) frames/s/chip")
                    ms = detail["devfe_serve"]["megastep"]
                    pairs["devfe_megastep"] = [
                        [ms["end_to_end_distinct_fps"],
                         ms["end_to_end_distinct_worst_fps"]],
                        [round(m2_best, 1), round(m2_worst, 1)]]
                    b0, w0 = paths["devfe_megastep"]
                    if m2_worst < w0:
                        ms["stages_ms_worst"] = m2_stw
                    paths["devfe_megastep"] = (max(b0, m2_best),
                                               max(w0, m2_worst))
                    ms["end_to_end_distinct_fps"] = round(
                        paths["devfe_megastep"][0], 1)
                    ms["end_to_end_distinct_worst_fps"] = round(
                        paths["devfe_megastep"][1], 1)
                    serve_status_steps = dfe_serve.last_status_steps
            detail["cif_sample_pairs_best_worst"] = pairs
            refresh_headline()
        except Exception as e:  # pragma: no cover
            log(f"second sample failed: {e!r}")
        emit("second_sample")
    else:
        log("second CIF sample skipped: budget exhausted")

    # ---- finalize: lane-status readbacks -----------------------------------
    emit("finalize_start")

    if dfe_serve is not None and serve_status is not None:
        st, err = bounded_device(lambda: np.asarray(serve_status), 120.0,
                                 "devfe serve status readback")
        if st is not None:
            n_ok = int((st == 0).sum())
            detail["devfe_serve"]["status_ok_streams"] = n_ok
            if n_ok != S_serve:
                log(f"devfe serve status: only {n_ok}/{S_serve} lanes ok "
                    f"-> demoting devfe from the headline")
                paths.pop("devfe_serve", None)
                refresh_headline()
        else:
            detail["devfe_serve"]["status_ok_streams"] = f"unread: {err}"
    if (serve_status_steps is not None
            and "megastep" in (detail.get("devfe_serve") or {})):
        stm, errm = bounded_device(
            lambda: np.asarray(serve_status_steps), 90.0,
            "devfe megastep status readback")
        ms = detail["devfe_serve"]["megastep"]
        if stm is not None:
            n_bad = int((stm != 0).sum())
            ms["bad_lane_frames_last_window"] = n_bad
            if n_bad:
                log(f"devfe megastep status: {n_bad} bad lane-frames in "
                    f"the last window -> demoting megastep")
                paths.pop("devfe_megastep", None)
                refresh_headline()
        else:
            ms["bad_lane_frames_last_window"] = f"unread: {errm}"

    if (dfe7_status is not None and detail.get("p720")
            and "devfe" in detail["p720"]):
        st7, err7 = bounded_device(lambda: np.asarray(dfe7_status), 90.0,
                                   "720p devfe status readback")
        if st7 is not None:
            detail["p720"]["devfe"]["status_ok_streams"] = int(
                (st7 == 0).sum())
        else:
            detail["p720"]["devfe"]["status_ok_streams"] = f"unread: {err7}"

    # A failed bit-exactness gate zeroes the headline: a build that is not
    # reference-strict has no throughput claim.  A failed devfe validation
    # demotes the devfe path (the host path keeps its claim).
    if str(detail["strict_rounding"]).startswith("FAILED"):
        result["value"] = 0.0
        result["vs_baseline"] = 0.0
        detail["headline_path"] = "none (strict gate failed)"
    elif detail["device_frontend_validation"] == "FAILED":
        if "devfe_serve" in paths:
            paths.pop("devfe_serve")
            refresh_headline()
            detail["headline_path"] = (detail["headline_path"] or "host") + \
                " (devfe demoted: validation failed)"

    emit("final")

    # Post-record status fetch: the serve/720p lane-status readbacks are
    # pure upside now that the final record is out — if the device lets
    # them through late, re-emit an upgraded final; if not, "unread"
    # stands.
    if (serve_status is not None
            and isinstance(detail.get("devfe_serve"), dict)
            and not isinstance(
                detail["devfe_serve"].get("status_ok_streams"), int)):
        # Second attempt, with the record already emitted.  Bounded well under the exit deadline so a truly wedged device
        # still exits cleanly (and early enough for the driver).
        _wedged["flag"] = False
        late_wait = 600.0
        if args.exit_deadline > 0:
            late_wait = max(0.0, min(600.0, (args.exit_deadline - 240.0)
                                     - (time.perf_counter() - bench_t0)))
        st, err = bounded_device(lambda: np.asarray(serve_status),
                                 late_wait, "late devfe status readback")
        if st is not None:
            n_ok = int((st == 0).sum())
            detail["devfe_serve"]["status_ok_streams"] = n_ok
            if n_ok != S_serve:
                paths.pop("devfe_serve", None)
                refresh_headline()
                detail["headline_path"] = (
                    f"{detail['headline_path']} (devfe demoted: "
                    f"{S_serve - n_ok} lanes errored)")
            if (dfe7_status is not None and detail.get("p720")
                    and "devfe" in detail["p720"]):
                st7, _ = bounded_device(lambda: np.asarray(dfe7_status),
                                        60.0, "late 720p status readback")
                if st7 is not None:
                    detail["p720"]["devfe"]["status_ok_streams"] = int(
                        (st7 == 0).sum())
            emit("final_status")

    disarm_overall()
    try:
        os.unlink(sidecar)
    except OSError:
        pass
    # A failed correctness gate fails the run: a build that is not
    # reference-exact has no throughput claim.
    rc = 0 if args.no_gates or (detail["gates"] or {}).get("ok") else 1
    # os._exit, not sys.exit: a bounded_device thread may still be wedged
    # inside a C-level device call; interpreter teardown then cancels it
    # mid-unwind and the C++ runtime aborts ("terminate called ... FATAL:
    # exception not rethrown").  Skip destructors entirely.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    main()
