"""Batched decoding with the device-side entropy front-end.

`DeviceFrontendDecoder` is the alternative production path to
`BatchedStreamDecoder`: instead of parsing the macroblock layer on the host
and shipping dense/packed tensors, it ships the RAW FRAME BYTES (the
minimal possible transfer — the compressed stream itself) in one uint8
leaf per step and runs the entire entropy decode on the device
(parser/device_frontend.py), followed by the same reconstruction program
every other transport uses (decoder/reconstruct.py::reconstruct_from_dense).

The host's remaining per-step work is picture-header parsing (a few dozen
bits per stream) and byte packing — everything else is one XLA program:

    bytes -> u32 words -> lockstep VLC automaton -> tapes -> scatters ->
    dense coefficients / MVs / INTER -> gather+IDCT+clamp -> planes

Reference-picture rules come out in the wash exactly as in the host
batched path: outputs become the reference planes unconditionally, which
is correct because errored lanes emit the identity frame (previous
picture persists, matching the whole-picture transaction of
state.rs:119-137) and legal DisposableP frames are all-uncoded (the
coded-MB quirk, macroblock.rs:461-464) so their output equals the
reference.

Per-stream decode status lives in a device-resident vector
(`last_status`); fetch it only at sync points (`fetch_status()`), since
a fetch waits for the device.  Streams outside the front-end's scope
(MODIFIED_QUANTIZATION, embedded GOB start codes; UMV is in scope since
round 4) or whose headers fail to parse are handled on the host: their
payload is replaced by a skip frame and their error surfaces through the
usual host exception path.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np

from ..bitio import BitReader
from ..decoder.reconstruct import check_pallas
from ..parser import device_frontend as df
from ..parser.picture import decode_picture
from ..types import (DecoderOption, H263Error, PictureOption,
                     PictureTypeCode, carry_forward_options)
from ..utils.trace import trace_stage


def make_whole_step(h: int, w: int, tape_len: int, harness: str = "xla",
                    unroll: int = 4, ragged: bool = False):
    """The (unjitted) whole-step program for an h x w bucket: raw bytes to
    planes.  Signature: step(data_u8, start_bit, nbits, quant0, ptype, v1,
    ref_y, ref_cb, ref_cr) -> (y, cb, cr, status).

    harness: "xla" (the only value) runs the automaton as a lax.while_loop.
    A Pallas kernel harness existed through round 4 but could never lower
    through Mosaic (VLC-table gathers) and was retired — the parameter
    stays so checkpoints and call sites keep their shape.  `unroll` trades compile time for loop overhead —
    automaton steps per while_loop body (see df.parse_frames_device).

    ragged: the payload leaf is a FLAT [Nw, 4] uint8 buffer holding every
    lane's word-aligned payload back to back, with a `base` word-offset
    argument inserted after data_u8 — step(data_u8, base, start_bit, ...).
    Ships sum(len) bytes instead of S * bucket(max len).
    """
    mbh, mbw = -(-h // 16), -(-w // 16)
    if harness != "xla":
        raise ValueError(
            f"unknown parse harness {harness!r}: the Pallas harness was "
            f"retired; only 'xla' remains")

    def step_core(words, base, start_bit, nbits, quant0, ptype, v1,
                  ref_y, ref_cb, ref_cr):
        from ..decoder.reconstruct import reconstruct_from_dense

        tapes = df.parse_frames_device(
            words, start_bit, nbits, quant0, ptype, v1,
            mbh=mbh, mbw=mbw, tape_len=tape_len, unroll=unroll,
            base=base, width=w, height=h)
        dense, mvs, inter, ok = df.assemble(tapes, mbh=mbh, mbw=mbw)
        y, cb, cr = reconstruct_from_dense(
            dense, mvs, inter, ref_y, ref_cb, ref_cr)
        return y, cb, cr, tapes["status"]

    if ragged:
        def step(data_u8, base, start_bit, nbits, quant0, ptype, v1,
                 ref_y, ref_cb, ref_cr):
            return step_core(df.payload_words(data_u8), base, start_bit,
                             nbits, quant0, ptype, v1, ref_y, ref_cb, ref_cr)
    else:
        def step(data_u8, start_bit, nbits, quant0, ptype, v1,
                 ref_y, ref_cb, ref_cr):
            return step_core(df.payload_words(data_u8), None, start_bit,
                             nbits, quant0, ptype, v1, ref_y, ref_cb, ref_cr)

    return step


@functools.lru_cache(maxsize=32)
def get_device_step_fn(h: int, w: int, tape_len: int, harness: str = "xla",
                       unroll: int = 4, ragged: bool = False):
    """Jitted make_whole_step, cached over (dims, tape bucket, parse
    harness, unroll, payload layout) so the jit cache stays bounded."""
    import jax

    return jax.jit(make_whole_step(h, w, tape_len, harness, unroll, ragged))


def make_whole_step_multi(h: int, w: int, tape_len: int, unroll: int = 4):
    """T-frame fused step: decode a WINDOW of T frames per lane in one
    device program (ragged payload, xla harness only).

    Where the single-frame step is bound by the per-call host floor
    (prep + transfer + dispatch), chaining T frames through one dispatch
    amortizes that floor T-ways.  A `lax.scan` over the per-frame meta rows
    carries the reference planes frame to frame ON DEVICE — the exact
    carry the reference performs between decode_next_picture calls
    (state.rs:429-463), lifted into the compiled program.

    Signature: step(data_u8 [Nw, 4], meta [T, 6, S] int32,
                    ref_y, ref_cb, ref_cr)
        -> (ys [T, S, h, w], cbs, crs, status [T, S])

    data_u8 holds ALL T frames' word-aligned payloads back to back; meta
    row 5 per frame is each lane's word offset into the SHARED flat
    buffer (the host rebases frame t's offsets by the running total).
    T is implicit in meta's leading dimension, so one jitted program per
    (dims, tape, T, payload-rung) shape — same compile-caching story as
    the single-frame rungs.
    """
    mbh, mbw = -(-h // 16), -(-w // 16)

    def step(data_u8, meta, ref_y, ref_cb, ref_cr):
        import jax

        from ..decoder.reconstruct import reconstruct_from_dense

        words = df.payload_words(data_u8)

        def body(carry, m):
            ry, rcb, rcr = carry
            tapes = df.parse_frames_device(
                words, m[0], m[1], m[2], m[3], m[4],
                mbh=mbh, mbw=mbw, tape_len=tape_len, unroll=unroll,
                base=m[5], width=w, height=h)
            dense, mvs, inter, ok = df.assemble(tapes, mbh=mbh, mbw=mbw)
            y, cb, cr = reconstruct_from_dense(
                dense, mvs, inter, ry, rcb, rcr)
            return (y, cb, cr), (y, cb, cr, tapes["status"])

        _, (ys, cbs, crs, status) = jax.lax.scan(
            body, (ref_y, ref_cb, ref_cr), meta)
        return ys, cbs, crs, status

    return step


@functools.lru_cache(maxsize=16)
def get_device_multi_step_fn(h: int, w: int, tape_len: int, unroll: int = 4):
    """Jitted make_whole_step_multi (T lives in the meta shape)."""
    import jax

    return jax.jit(make_whole_step_multi(h, w, tape_len, unroll))


class DeviceFrontendDecoder:
    """Decode S same-resolution Sorenson streams with the device front-end.

    API mirrors BatchedStreamDecoder's core: decode_step(list[bytes]) ->
    device-resident (y, cb, cr); present_rgba(); ref planes as attributes.
    """

    def __init__(self, n_streams: int, width: int, height: int,
                 decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 pallas: str = "auto", tape_len: Optional[int] = None,
                 max_frame_bytes: Optional[int] = None,
                 harness: str = "xla", unroll: int = 4, step_fn=None,
                 payload: str = "auto"):
        import jax.numpy as jnp

        # Both bitstream flavors decode here: the automaton speaks the
        # shared MB layer, including UMV's table-D.3 MVDs, range rules,
        # the GOB-resync scan on soft MB errors, and (r5) the
        # MODIFIED_QUANTIZATION UnimplementedDecoding stub — no per-frame
        # host gate remains (df.supports is unconditional).
        check_pallas(pallas)

        self.n = n_streams
        self.w, self.h = width, height
        self.cw, self.ch = (width + 1) // 2, (height + 1) // 2
        self.mb_w, self.mb_h = -(-width // 16), -(-height // 16)
        self.decoder_options = decoder_options
        nmb = self.mb_w * self.mb_h
        # Iteration budget: per MB, 1 header + up to 4 MVD pairs + 6
        # INTRADC + one slot per coefficient.  The default covers 24 slots
        # per macroblock (typical P content uses ~6, intra-heavy ~12-20);
        # overflow is a flagged, recoverable condition (ST_TAPE_OVERFLOW ->
        # identity frame + device-resident status; resolve_overflows()
        # repairs the lane host-side at the next sync point), mirroring
        # the packed transport's pack_cap contract.
        self.tape_len = tape_len or 24 * nmb
        # Transfer cap for the raw payload (bytes); frames above it fall
        # back to the skip-frame path with a host-raised error.  Within the
        # cap, each step ships the smallest bucket of a geometric ladder
        # that covers the step's longest payload — padding to the decoder
        # cap wasted 4-5x of the transfer bytes on typical content.  The ladder is small and static so each bucket
        # jit-compiles at most once per process (no per-step shape churn).
        self.max_frame_bytes = max_frame_bytes or 8192
        cap = ((self.max_frame_bytes + 3) // 4) * 4
        self.max_frame_bytes = cap
        self._buckets = []
        b = cap
        while b >= 1024 and len(self._buckets) < 4:
            self._buckets.append(b)
            b = ((b // 2 + 3) // 4) * 4
        if not self._buckets:
            self._buckets = [cap]
        self._buckets.sort()
        if harness != "xla":
            raise ValueError(
                f"unknown parse harness {harness!r}: the Pallas harness "
                f"was retired; only 'xla' remains")
        self.harness = harness
        self.unroll = unroll
        # step_fn injection: a pre-jitted whole-step program (e.g. the
        # mesh-sharded one from sharding.shard_device_frontend_fn) replaces
        # the default single-device jit.  Must have make_whole_step's
        # signature and THIS decoder's tape_len/dims.
        self._step_fn_arg = step_fn  # resolved into self._fn below, after
        # the native prep exists (the ragged payload layout needs it)

        self.ref_y = jnp.zeros((n_streams, self.h, self.w), dtype=jnp.uint8)
        self.ref_cb = jnp.zeros((n_streams, self.ch, self.cw), dtype=jnp.uint8)
        self.ref_cr = jnp.zeros((n_streams, self.ch, self.cw), dtype=jnp.uint8)
        self.last_status = None        # device-resident int32 [S]
        self.last_status_steps = None  # decode_steps: int32 [T, S] (device)
        self._fn_multi = None          # lazily-built window step program
        self._last_window = None       # (pre-window refs, window buffers)
        # Last step's host->device payload cost (see batch.py: the pool's
        # degraded-window monitor reads these after every step).
        self.last_transfer_s = 0.0
        self.last_transfer_bytes = 0
        self._pictures = [None] * n_streams
        # Carried running options per stream (state.rs:147-155) — the
        # supports() gate and overflow repair must see carried UMV /
        # MODIFIED_QUANTIZATION, which a plain PTYPE's own bits lack.
        self._running = [PictureOption.NONE] * n_streams
        self._last_buffers: list = [None] * n_streams
        self._skip: Optional[bytes] = None
        # Last-good per-stream presentation params (quantizer -> deblock
        # strength, advisory deblocker flag) — kept as plain arrays so the
        # native prep path needs no Picture objects.
        self._last_quant = np.full(n_streams, 8, dtype=np.int32)
        self._last_deblock = np.zeros(n_streams, dtype=np.bool_)
        # Ping-pong host staging for the payload leaf, one pair per transfer
        # bucket, allocated lazily (device_put may read asynchronously —
        # same reuse gate as batch.py, tracked per buffer pair).
        Lw = (self.max_frame_bytes + 3) // 4
        self._stage_pp: dict = {}  # bucket -> {stage, meta, idx, in_flight}
        # Native host prep (batched header parse + staging copy): one FFI
        # call instead of a ~8 ms/step Python header loop at S=256.
        self._prep = None
        import os

        if (not os.environ.get("H263_TPU_NO_NATIVE")
                and decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM):
            # The native prep parses Sorenson headers; standard pictures
            # (PTYPE/PLUSPTYPE chains + the GOB-scan gate) stay on the
            # Python prep loop.
            from ..native import ensure_built

            if ensure_built():
                from ..native.bindings import DevicePrepBatch

                self._prep = DevicePrepBatch(n_streams, width, height,
                                             Lw * 4)

        # Payload layout.  "rows": uint8 [S, Lw, 4] rows padded to the
        # step's max-lane bucket.  "ragged": ONE flat [Nw, 4] buffer with
        # per-lane word offsets (make_whole_step ragged) — ships ~sum(len)
        # bytes instead of S * bucket(max len), and a single long frame
        # (I-frame, joiner) no longer forces every lane to its bucket.
        # "auto" picks ragged when the prerequisites hold: default step fn
        # (injected programs own their signature) and the native prep
        # (which packs the flat buffer; the Python staging loop stays
        # rows-only).
        if payload == "auto":
            payload = ("ragged" if (step_fn is None
                                    and self._prep is not None) else "rows")
        elif payload == "ragged":
            if step_fn is not None:
                raise ValueError("payload='ragged' requires the default "
                                 "step fn")
            if self._prep is None:
                raise ValueError("payload='ragged' requires the native prep")
        elif payload != "rows":
            raise ValueError(f"unknown payload layout {payload!r}")
        self.payload = payload
        self._fn = self._step_fn_arg or get_device_step_fn(
            height, width, self.tape_len, harness, unroll,
            ragged=(payload == "ragged"))

    # -- host-side helpers ---------------------------------------------------

    def _skip_frame_bytes(self) -> bytes:
        """An all-uncoded P-frame: decodes to the identity frame.  Encoded
        in the decoder's own flavor so its header parses under the same
        options."""
        if self._skip is None:
            from ..testing.encoder import (
                MBSpec,
                encode_sorenson_picture,
                encode_standard_picture,
            )

            enc = (encode_sorenson_picture
                   if self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM
                   else encode_standard_picture)
            self._skip = enc(
                self.w, self.h, PictureTypeCode.P_FRAME,
                [MBSpec(kind="uncoded")] * (self.mb_w * self.mb_h),
                temporal_reference=0)
        return self._skip

    def _pick_bucket(self, buffers) -> int:
        """Smallest ladder bucket covering every payload this step will
        stage.  Absent (None) and over-cap payloads stage the skip frame,
        so they count at the skip frame's length; over-cap frames are
        rejected per stream either way (native rc / host H263Error)."""
        cap = self.max_frame_bytes
        need = 1
        skiplen = None
        for b in buffers:
            if b is None or len(b) > cap:
                if skiplen is None:
                    skiplen = len(self._skip_frame_bytes())
                need = max(need, skiplen)
            else:
                need = max(need, len(b))
        for b in self._buckets:
            if b >= need:
                return b
        return self._buckets[-1]

    def _pick_bucket_ragged(self, bufs) -> int:
        """Total flat-buffer bytes for this step, quantized to a 2^(1/4)
        geometric grid (<=19% padding, ~9% mean).  Each rung that is
        actually HIT jit-compiles once (jax caches per shape); steady-state
        content occupies 1-2 adjacent rungs, so the fine grid does not
        cause a compile storm the way per-step exact shapes would."""
        return self._quantize_ragged(
            sum(((len(b) + 3) // 4) * 4 for b in bufs))

    @staticmethod
    def _quantize_ragged(need: int) -> int:
        import math

        need = max(4096, need)
        k = max(0, math.ceil(math.log2(need / 4096.0) * 4.0))
        bucket = ((int(math.ceil(4096.0 * 2.0 ** (k / 4.0))) + 3) // 4) * 4
        # Guard against float edge: the rung must cover need.
        while bucket < need:
            k += 1
            bucket = ((int(math.ceil(4096.0 * 2.0 ** (k / 4.0))) + 3)
                      // 4) * 4
        return bucket

    def _next_stage_ragged(self, bucket: int):
        key = ("ragged", bucket)
        pp = self._stage_pp.get(key)
        if pp is None:
            pp = dict(
                stage=[np.zeros((bucket // 4, 4), dtype=np.uint8)
                       for _ in range(2)],
                meta=[np.zeros((6, self.n), dtype=np.int32)
                      for _ in range(2)],
                idx=0, in_flight=[None, None])
            self._stage_pp[key] = pp
        pp["idx"] ^= 1
        i = pp["idx"]
        if pp["in_flight"][i] is not None:
            with trace_stage("reclaim_wait"):
                for a in pp["in_flight"][i]:
                    a.block_until_ready()
            pp["in_flight"][i] = None
        return pp, pp["stage"][i], pp["meta"][i]

    def _next_stage(self, bucket: int):
        pp = self._stage_pp.get(bucket)
        if pp is None:
            Lw = bucket // 4
            pp = dict(
                stage=[np.zeros((self.n, Lw, 4), dtype=np.uint8)
                       for _ in range(2)],
                meta=[np.zeros((5, self.n), dtype=np.int32)
                      for _ in range(2)],
                idx=0, in_flight=[None, None])
            self._stage_pp[bucket] = pp
        pp["idx"] ^= 1
        i = pp["idx"]
        if pp["in_flight"][i] is not None:
            with trace_stage("reclaim_wait"):
                for a in pp["in_flight"][i]:
                    a.block_until_ready()
            pp["in_flight"][i] = None
        return pp, pp["stage"][i], pp["meta"][i]

    def decode_step(self, buffers: Sequence[bytes], mask=None):
        """Decode one frame per stream.  Returns device-resident (y, cb, cr)
        uint8 batches; per-stream status lands in self.last_status (device).

        `mask` (bool per slot, optional): False slots decode the cached
        skip frame with header commit suppressed — identical to passing
        None for that slot (the StreamPool absent-stream contract).

        Host-side failures (unparseable/oversized headers, out-of-scope
        streams) substitute the skip frame for that stream and re-raise the
        first error AFTER dispatch, preserving per-stream isolation.
        """
        import jax

        if len(buffers) != self.n:
            raise ValueError(f"expected {self.n} buffers, got {len(buffers)}")
        if mask is not None:
            buffers = [b if mask[i] else None for i, b in enumerate(buffers)]

        ragged = self.payload == "ragged"
        if ragged:
            # Over-cap frames stage as empty payloads (header parse fails
            # -> identity frame + surfaced error), matching the rows
            # path's native per-frame cap rejection; absent lanes decode
            # the skip frame as usual.
            cap = self.max_frame_bytes
            r_bufs = [self._skip_frame_bytes() if b is None
                      else (b"" if len(b) > cap else b) for b in buffers]
            bucket = self._pick_bucket_ragged(r_bufs)
            pp, stage, meta = self._next_stage_ragged(bucket)
        else:
            bucket = self._pick_bucket(buffers)
            pp, stage, meta = self._next_stage(bucket)
        first_err: Optional[Exception] = None
        with trace_stage("host_parse"):
            if self._prep is not None:
                if ragged:
                    bufs = r_bufs
                    failed = self._prep.prepare_ragged(bufs, stage, meta)
                else:
                    bufs = [self._skip_frame_bytes() if b is None else b
                            for b in buffers]
                    failed = self._prep.prepare(bufs, stage, meta)
                hdr = self._prep.hdr
                # Absent (None) lanes decode the skip frame but must keep
                # their LAST REAL frame's presentation params (quantizer ->
                # deblock strength, advisory flag) — same header-commit
                # suppression as the host batched path's masked slots.
                okm = self._prep.rc == 0
                commit = okm & np.array(
                    [b is not None for b in buffers], dtype=bool)
                np.copyto(self._last_quant, hdr[:, 6], where=commit)
                np.copyto(self._last_deblock, hdr[:, 5] != 0, where=commit)
                if failed:
                    # Failed rows were staged as empty streams (identity
                    # frames); surface the first failure like the host
                    # batched path, after the step below still dispatches.
                    i = int(np.argmin(okm))
                    first_err = H263Error(
                        f"stream {i}: header rejected by device front-end "
                        f"prep (rc {int(self._prep.rc[i])})")
            else:
                stage[:] = 0
                start_bit, nbits, quant0, ptype, v1 = meta
                for i, buf in enumerate(buffers):
                    absent = buf is None
                    if absent:
                        buf = self._skip_frame_bytes()
                    running = None   # set when the real header parses
                    try:
                        if len(buf) > self.max_frame_bytes:
                            raise H263Error(
                                f"frame exceeds transfer bucket "
                                f"({len(buf)} > {self.max_frame_bytes} bytes)")
                        r = BitReader(buf)
                        pic = decode_picture(r, self.decoder_options,
                                             self._pictures[i])
                        if pic is None:
                            raise H263Error("outside device front-end scope")
                        fmt = pic.format.width_and_height() if pic.format else None
                        if fmt is not None and fmt != (self.w, self.h):
                            raise H263Error(
                                f"stream {i} resolution {fmt} != bucket "
                                f"({self.w}, {self.h})")
                        # The MB layer runs against the stream's CARRIED
                        # running options (state.rs:147-155), not the
                        # frame's own bits — a plain-PTYPE picture after a
                        # UMV/MODIFIED_QUANTIZATION OPPTYPE still decodes
                        # under those options; encode_ptype below ships
                        # them to the automaton (r5: MQ included — no
                        # host gate remains, supports() is unconditional).
                        running = carry_forward_options(
                            pic, self._running[i])
                        if not absent:
                            self._pictures[i] = pic
                            self._running[i] = running
                        if not absent:
                            # Absent lanes keep their last real frame's
                            # presentation params (header-commit
                            # suppression, as the host path's masked slots).
                            self._last_quant[i] = pic.quantizer
                            from ..types import PictureOption

                            self._last_deblock[i] = bool(
                                pic.options & PictureOption.USE_DEBLOCKER)
                    except H263Error as e:
                        if first_err is None:
                            first_err = e
                        buf = self._skip_frame_bytes()
                        r = BitReader(buf)
                        pic = decode_picture(r, self.decoder_options, None)
                        running = None   # skip frame carries no options
                    flat = stage[i].reshape(-1)
                    flat[:len(buf)] = np.frombuffer(buf, dtype=np.uint8)
                    start_bit[i] = r.pos
                    nbits[i] = len(buf) * 8
                    quant0[i] = pic.quantizer
                    ptype[i] = df.encode_ptype(pic, running)
                    v1[i] = 1 if pic.version == 1 else 0

        import time as _time

        _t0 = _time.perf_counter()
        with trace_stage("transfer"):
            dev_stage = jax.device_put(stage)
            dev_meta = jax.device_put(meta)
        self.last_transfer_s = _time.perf_counter() - _t0
        self.last_transfer_bytes = stage.nbytes + meta.nbytes
        # HOST BUFFER REUSE GATE (batch.py): the device_put may read
        # `stage`/`meta` asynchronously.  Park the transferred arrays in
        # the in-flight slot NOW so that even if the dispatch below raises
        # and the caller keeps stepping (per-stream isolation), the next
        # reuse of this ping-pong buffer blocks until the transfer is done.
        pp["in_flight"][pp["idx"]] = (dev_stage, dev_meta)

        with trace_stage("reconstruct_dispatch"):
            if ragged:
                y, cb, cr, status = self._fn(
                    dev_stage, dev_meta[5], dev_meta[0], dev_meta[1],
                    dev_meta[2], dev_meta[3], dev_meta[4],
                    self.ref_y, self.ref_cb, self.ref_cr)
            else:
                y, cb, cr, status = self._fn(
                    dev_stage, dev_meta[0], dev_meta[1], dev_meta[2],
                    dev_meta[3], dev_meta[4],
                    self.ref_y, self.ref_cb, self.ref_cr)
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        self.last_status = status
        pp["in_flight"][pp["idx"]] = (y, cb, cr)
        self._last_buffers = list(buffers)
        # A single-frame step advances the reference planes past the last
        # decode_steps window: its pre-window snapshot is no longer the
        # planes any replay should start from.  Invalidate it so a stale
        # resolve_window_overflows cannot overwrite the advanced refs.
        self._last_window = None
        self.last_status_steps = None

        if first_err is not None:
            raise first_err
        return y, cb, cr

    # -- multi-frame window step ---------------------------------------------

    def _next_stage_ragged_multi(self, T: int, bucket: int):
        key = ("raggedT", T, bucket)
        pp = self._stage_pp.get(key)
        if pp is None:
            pp = dict(
                stage=[np.zeros((bucket // 4, 4), dtype=np.uint8)
                       for _ in range(2)],
                meta=[np.zeros((T, 6, self.n), dtype=np.int32)
                      for _ in range(2)],
                idx=0, in_flight=[None, None])
            self._stage_pp[key] = pp
        pp["idx"] ^= 1
        i = pp["idx"]
        if pp["in_flight"][i] is not None:
            with trace_stage("reclaim_wait"):
                for a in pp["in_flight"][i]:
                    a.block_until_ready()
            pp["in_flight"][i] = None
        return pp, pp["stage"][i], pp["meta"][i]

    def decode_steps(self, frame_lists: Sequence[Sequence[bytes]]):
        """Decode a WINDOW of T frames per stream in ONE device dispatch.

        `frame_lists`: T sequences of S buffers (None = absent slot, which
        decodes the cached skip frame with header commit suppressed, as in
        decode_step).  Returns device-resident uint8 (ys, cbs, crs) stacked
        [T, S, ...]; per-(frame, stream) status lands in
        `self.last_status_steps` (int32 [T, S], device) and the FINAL
        frame's row in `self.last_status` (the slot-recycle contract).

        Rationale: at the serving shape the single-frame step is bound by
        the fixed per-dispatch host cost (prep + device_put RPC + dispatch
        RPC); one window dispatch pays that floor once for T frames — see
        make_whole_step_multi.  Requires the ragged payload layout (native
        prep packs all T frames back to back into one flat leaf).

        Error semantics per (frame, lane) are decode_step's: a failed lane
        emits the identity frame FOR THAT FRAME and later window frames
        decode against the surviving reference — exactly the sequence of
        single steps with no host repair in between.  Mid-window
        ST_TAPE_OVERFLOW therefore cannot be repaired by
        resolve_overflows (the intra-window reference has moved on);
        use resolve_window_overflows(), which replays a flagged lane's
        whole window from the pre-window planes kept for that purpose.
        """
        import jax

        if self.payload != "ragged" or self._prep is None:
            raise ValueError(
                "decode_steps requires payload='ragged' (native prep)")
        T = len(frame_lists)
        if T < 1:
            raise ValueError("empty window")
        cap = self.max_frame_bytes
        r_lists = []
        for bufs in frame_lists:
            if len(bufs) != self.n:
                raise ValueError(
                    f"expected {self.n} buffers, got {len(bufs)}")
            r_lists.append([self._skip_frame_bytes() if b is None
                            else (b"" if len(b) > cap else b) for b in bufs])
        wbytes_t = [sum(((len(b) + 3) // 4) * 4 for b in bufs)
                    for bufs in r_lists]
        bucket = self._quantize_ragged(sum(wbytes_t))
        pp, stage, meta = self._next_stage_ragged_multi(T, bucket)
        flat = stage.reshape(-1)
        first_err: Optional[Exception] = None
        woff = 0  # running word offset into the shared flat buffer
        with trace_stage("host_parse"):
            for t, bufs in enumerate(r_lists):
                # Exact-size view: the prep zero-fills its view's tail, so
                # handing it the whole remaining buffer would memset the
                # full bucket T times.
                view = flat[woff * 4: woff * 4 + wbytes_t[t]]
                failed = self._prep.prepare_ragged(bufs, view, meta[t])
                okm = self._prep.rc == 0
                commit = okm & np.array(
                    [b is not None for b in frame_lists[t]], dtype=bool)
                np.copyto(self._last_quant, self._prep.hdr[:, 6],
                          where=commit)
                np.copyto(self._last_deblock, self._prep.hdr[:, 5] != 0,
                          where=commit)
                if failed and first_err is None:
                    i = int(np.argmin(okm))
                    first_err = H263Error(
                        f"frame {t} stream {i}: header rejected by device "
                        f"front-end prep (rc {int(self._prep.rc[i])})")
                # Rebase frame t's lane offsets into the shared buffer and
                # advance by what the prep consumed (failed lanes stage no
                # payload and consume nothing).
                meta[t, 5] += woff
                woff += int(np.sum(np.where(
                    okm, (self._prep._lengths + 3) // 4, 0)))
            # Whole-buffer zero-fill invariant (single-frame ragged parity,
            # TestRaggedPayload): a reused ping-pong buffer keeps the
            # PREVIOUS window's bytes past this window's payload end.  The
            # automaton's reads past nbits are rem-gated, but correctness
            # must not rest on that alone — zero the residual up to this
            # buffer's high-water mark (cheap: only previously-dirtied
            # bytes, not the whole bucket).
            hw = pp.setdefault("highwater", [0, 0])
            if hw[pp["idx"]] > woff * 4:
                flat[woff * 4: hw[pp["idx"]]] = 0
            hw[pp["idx"]] = woff * 4

        import time as _time

        _t0 = _time.perf_counter()
        with trace_stage("transfer"):
            dev_stage = jax.device_put(stage)
            dev_meta = jax.device_put(meta)
        self.last_transfer_s = _time.perf_counter() - _t0
        self.last_transfer_bytes = stage.nbytes + meta.nbytes
        pp["in_flight"][pp["idx"]] = (dev_stage, dev_meta)

        # Keep the PRE-window planes alive for window-granularity overflow
        # repair (resolve_window_overflows) — device arrays are immutable,
        # so this is a reference, not a copy.
        prev_refs = (self.ref_y, self.ref_cb, self.ref_cr)

        if self._fn_multi is None:
            self._fn_multi = get_device_multi_step_fn(
                self.h, self.w, self.tape_len, self.unroll)
        with trace_stage("reconstruct_dispatch"):
            ys, cbs, crs, status = self._fn_multi(
                dev_stage, dev_meta, self.ref_y, self.ref_cb, self.ref_cr)
        self.ref_y = ys[T - 1]
        self.ref_cb = cbs[T - 1]
        self.ref_cr = crs[T - 1]
        self.last_status_steps = status
        self.last_status = status[T - 1]
        pp["in_flight"][pp["idx"]] = (ys, cbs, crs)
        self._last_window = (prev_refs, [list(bufs) for bufs in r_lists])
        self._last_buffers = list(frame_lists[T - 1])

        if first_err is not None:
            raise first_err
        return ys, cbs, crs

    def resolve_window_overflows(self, status=None) -> list:
        """resolve_overflows for decode_steps windows: lanes that flagged
        ST_TAPE_OVERFLOW at ANY frame of the last window are replayed
        frame-by-frame through the host front-end from the pre-window
        reference planes (kept by decode_steps).  Lanes whose replay hits a
        genuine stream error keep the window's device result (identity-
        frame contract).  Returns the repaired lane indices.
        """
        from ..decoder.state import reconstruct_frame_numpy
        from ..parser.frame import parse_frame_auto

        if getattr(self, "_last_window", None) is None:
            return []
        if status is None:
            status = np.asarray(self.last_status_steps)
        (py, pcb, pcr), window = self._last_window
        # Recycled slots have their window buffers cleared to None by
        # reset_slot_state — never replay a departed occupant's window.
        lanes = [i for i in range(self.n)
                 if np.any(status[:, i] == df.ST_TAPE_OVERFLOW)
                 and all(bufs[i] is not None for bufs in window)]
        repaired = []
        for i in lanes:
            ry = np.asarray(py[i])
            rcb = np.asarray(pcb[i])
            rcr = np.asarray(pcr[i])
            pic_prev = None
            try:
                for bufs in window:
                    buf = bytes(bufs[i])
                    r = BitReader(buf)
                    pic = decode_picture(r, self.decoder_options, pic_prev)
                    frame = parse_frame_auto(
                        r, pic, self.decoder_options,
                        self._running[i], self.w, self.h)
                    ry, rcb, rcr = reconstruct_frame_numpy(
                        frame, ry, rcb, rcr)
                    pic_prev = pic
            except H263Error:
                continue
            self.ref_y = self.ref_y.at[i].set(ry)
            self.ref_cb = self.ref_cb.at[i].set(rcb)
            self.ref_cr = self.ref_cr.at[i].set(rcr)
            repaired.append(i)
        if repaired:
            idx = np.asarray(repaired, dtype=np.int32)
            self.last_status = self.last_status.at[idx].set(0)
        return repaired

    def reset_slot_state(self, slot: int, running=None) -> None:
        """Reset one lane to the fresh-stream state (planes zeroed, no
        previous header) — the StreamPool slot-recycle contract.  `running`
        seeds the carried options (standard-H.263 rebucket); None means a
        fresh stream."""
        self.ref_y = self.ref_y.at[slot].set(0)
        self.ref_cb = self.ref_cb.at[slot].set(0)
        self.ref_cr = self.ref_cr.at[slot].set(0)
        self._pictures[slot] = None
        self._running[slot] = (PictureOption.NONE if running is None
                               else running)
        self._last_buffers[slot] = None
        self._last_quant[slot] = 8
        self._last_deblock[slot] = False
        if self.last_status is not None:
            # A recycled slot must not report the departed stream's
            # error/overflow status for its new occupant.
            self.last_status = self.last_status.at[slot].set(0)
        # Any pending decode_steps window belongs to the departed occupant:
        # a later resolve_window_overflows must not replay its frames over
        # the recycled slot's fresh planes.
        if self.last_status_steps is not None:
            self.last_status_steps = self.last_status_steps.at[:, slot].set(0)
        if self._last_window is not None:
            for bufs in self._last_window[1]:
                bufs[slot] = None

    def resolve_overflows(self, status: Optional[np.ndarray] = None) -> list:
        """Repair lanes whose LAST step hit ST_TAPE_OVERFLOW by re-decoding
        their frame through the host front-end (the documented fallback —
        overflow is a transport-capacity artifact, not a stream error).

        Call at a sync point, right after the step whose status flagged the
        overflow and BEFORE the next decode_step (the identity planes the
        overflow left behind are exactly that frame's reference, which the
        host re-decode consumes).  Per-lane cost: one sliced plane readback
        + a host parse + golden reconstruction + one device plane update —
        sync-point work, like fetch_status itself.

        Frames that ALSO fail to parse on the host keep the identity frame
        (the normal errored-lane contract).  Returns the repaired lane
        indices; repaired lanes' last_status entries reset to 0.  NB: the
        repair lands in self.ref_* (and every later step/present); arrays
        the overflowing decode_step already RETURNED are immutable and
        keep the identity planes — re-slice from the decoder after repair.
        """
        from ..decoder.state import reconstruct_frame_numpy
        from ..parser.frame import parse_frame_auto

        if self.last_status is None:
            return []  # never stepped: nothing to repair
        if self._last_window is not None:
            # The last step was a decode_steps window: single-frame repair
            # would both miss mid-window overflows (last_status holds only
            # the final frame's row) and replay against an intra-window-
            # corrupted reference.  Window repair subsumes it.
            return self.resolve_window_overflows()
        if status is None:
            status = self.fetch_status()
        lanes = [i for i in range(self.n)
                 if status[i] == df.ST_TAPE_OVERFLOW
                 and self._last_buffers[i] is not None]
        if not lanes:
            return []
        repaired = []
        for i in lanes:
            buf = bytes(self._last_buffers[i])
            try:
                r = BitReader(buf)
                pic = decode_picture(r, self.decoder_options,
                                     self._pictures[i])
                # self._running[i] was committed for THIS frame during the
                # overflowing decode_step, so it is the frame's carried
                # running options (pic.options would drop inherited ones).
                frame = parse_frame_auto(r, pic, self.decoder_options,
                                         self._running[i], self.w, self.h)
                # The overflowed step emitted the identity frame, so this
                # lane's current planes ARE the frame's reference planes.
                ry = np.asarray(self.ref_y[i])
                rcb = np.asarray(self.ref_cb[i])
                rcr = np.asarray(self.ref_cr[i])
                y, cb, cr = reconstruct_frame_numpy(frame, ry, rcb, rcr)
            except H263Error:
                continue  # genuinely bad stream: identity frame stands
            self.ref_y = self.ref_y.at[i].set(y)
            self.ref_cb = self.ref_cb.at[i].set(cb)
            self.ref_cr = self.ref_cr.at[i].set(cr)
            repaired.append(i)
        if repaired:
            idx = np.asarray(repaired, dtype=np.int32)
            self.last_status = self.last_status.at[idx].set(0)
        return repaired

    def fetch_status(self) -> np.ndarray:
        """Read back the last step's per-stream status (int32; 0 = ok).

        SYNC POINT: waits for the step — call this at end-of-GOP /
        validation barriers, not per step."""
        return np.asarray(self.last_status)

    def present_rgba(self, deblock: Optional[bool] = None):
        import jax.numpy as jnp

        from ..decoder.reconstruct import get_present_fn
        from ..ops.deblock import QUANT_TO_STRENGTH

        strength = QUANT_TO_STRENGTH[self._last_quant & 31].astype(np.int32)
        flags = (self._last_deblock if deblock is None
                 else np.full(self.n, deblock, dtype=np.bool_))
        fn = get_present_fn(self.h, self.w)
        return fn(self.ref_y, self.ref_cb, self.ref_cr,
                  jnp.asarray(strength), jnp.asarray(flags))
