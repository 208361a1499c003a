"""Mixed-resolution stream pool with dynamic membership.

Streams of different resolutions cannot share one XLA program (static
shapes), so the pool groups them into per-resolution BatchedStreamDecoder
buckets (SURVEY.md §7 hard part 4: "bucket by MB count and pad").  Buckets
decode independently; within a bucket, slots decode in lockstep with
padding, giving a serving-shaped lifecycle (VERDICT r1 item 4):

* **join** — `add_stream` at any time; a free slot is recycled, or the
  bucket grows (amortized doubling; one recompile per growth, never
  per-step shape churn).
* **leave** — `remove_stream` frees the slot; its state resets and the
  slot pads with skip frames until reused.
* **absent** — a registered stream may simply not supply a frame for a
  step; its slot decodes the cached all-uncoded skip frame with header
  commit suppressed, so its planes and state are untouched.
* **resolution change** — a stream whose next frame is an I-frame at new
  dimensions is rebucketed transparently (running options carry over;
  reference planes reset, exactly like the single-stream decoder's
  I-frame semantics, state.rs:464-470).  A non-I frame at wrong
  dimensions is a per-stream error (there is no reference picture at the
  new size to predict from).

Buckets decode with either entropy front-end (`frontend="host"` — the
default BatchedStreamDecoder — or `"device"` — the device entropy
automaton); the lifecycle above is front-end-agnostic.  Device pools
also serve the K-frame megastep: `decode_steps` decodes a window of T
frames with one transfer leaf + one dispatch per bucket
(DeviceFrontendDecoder.decode_steps; its gain on the GPU is not
measured yet), falling back to
sequential steps around resolution changes.

Degraded-window adaptation (`adaptive_frontend=True`, Sorenson pools):
a host->device link whose bandwidth collapses for minutes at a time
makes transfer bytes convert ~linearly to wall-clock, and byte reduction
is then the only lever that still works.  The pool keeps an EMA of the
observed host->device bandwidth (every bucket decoder reports its last
step's payload bytes/seconds) and, when it collapses `degrade_ratio`x
below the best window seen, switches every bucket to the device
front-end live — the raw-bitstream leaf is the smallest possible
transport (4-10x fewer bytes at CIF).  The switch transplants reference
planes (device-resident, no readback) and carried per-stream header
state; it is one-way and sticky (switching back on recovery would churn
compiles and re-expose the bigger transport to the next bad window).
Counters: pool_degraded_window_detected, pool_frontend_switches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..bitio import BitReader
from ..types import (
    DecoderOption,
    H263Error,
    PictureFormatInvalid,
    PictureOption,
    PictureTypeCode,
)
from .batch import BatchedStreamDecoder
from ..utils.trace import incr


class _Bucket:
    __slots__ = ("dec", "slots", "free")

    def __init__(self, dec: BatchedStreamDecoder):
        self.dec = dec
        self.slots: dict = {}   # stream_id -> slot index
        self.free: list = list(range(dec.n))[::-1]  # stack of free slots

    def mask(self, present) -> np.ndarray:
        m = np.zeros(self.dec.n, dtype=bool)
        for sid, slot in self.slots.items():
            if sid in present:
                m[slot] = True
        return m


#: Plain-PTYPE / OPPTYPE 3-bit source-format codes -> dims (H.263 table 2).
_STD_FMT_DIMS = {1: (128, 96), 2: (176, 144), 3: (352, 288),
                 4: (704, 576), 5: (1408, 1152)}


def _sniff_standard_probe(buf: bytes, current_dims):
    """Cheap dims probe for STANDARD pictures: "unchanged", "changed", or
    None (ambiguous — caller must run the full header parse).

    Reads fixed-offset PTYPE/PLUSPTYPE fields from the first 8 bytes:
    PSC(17) GN(5) TR(8) PTYPE['1','0',3 flags] fmt(3); fmt 1-5 are fixed
    formats, 7 is PLUSPTYPE (UFEP(3): 000 inherits the previous format,
    001 carries OPPTYPE whose own fmt(3) is read the same way; custom
    formats need CPFMT and fall back).  Only "unchanged" short-circuits;
    correctness requires never returning it when the true dims differ —
    inherited formats (UFEP=000, absent plain fmt) are unchanged by
    definition."""
    if len(buf) < 8:
        return None
    v = int.from_bytes(buf[:8], "big")
    if (v >> 42) != 0b1_00000:      # PSC(17) + GN==0
        return None
    if (v >> 33) & 1 != 1 or (v >> 32) & 1 != 0:  # PTYPE '10' marker
        return None
    fmt = (v >> 26) & 7
    if fmt in _STD_FMT_DIMS:
        return ("unchanged" if _STD_FMT_DIMS[fmt] == tuple(current_dims)
                else "changed")
    if fmt != 7:
        return None  # forbidden/reserved: full parse raises precisely
    ufep = (v >> 23) & 7
    if ufep == 0:
        return "unchanged"  # no OPPTYPE: format inherited
    if ufep != 1:
        return None
    ofmt = (v >> 20) & 7
    if ofmt in _STD_FMT_DIMS:
        return ("unchanged" if _STD_FMT_DIMS[ofmt] == tuple(current_dims)
                else "changed")
    return None  # custom (CPFMT) or reserved


def _sniff_sorenson(buf: bytes):
    """(width, height, is_iframe) from a Sorenson picture header, or None.

    Layout (picture.rs:628-659): PSC(17) version(5) TR(8) fmt(3)
    [custom dims 8+8 or 16+16] ptype(2) ...
    """
    if len(buf) < 9:
        return None
    word = int.from_bytes(buf[:9], "big")  # 72 bits
    top = word >> (72 - 17)
    if top != 1:
        return None
    rest = word & ((1 << 55) - 1)          # after PSC
    fmt = (rest >> (55 - 5 - 8 - 3)) & 0x7
    pos = 5 + 8 + 3
    if fmt == 0:
        w = (rest >> (55 - pos - 8)) & 0xFF
        h = (rest >> (55 - pos - 16)) & 0xFF
        pos += 16
    elif fmt == 1:
        w = (rest >> (55 - pos - 16)) & 0xFFFF
        h = (rest >> (55 - pos - 32)) & 0xFFFF
        pos += 32
    else:
        dims = {2: (352, 288), 3: (176, 144), 4: (128, 96),
                5: (320, 240), 6: (160, 120)}.get(fmt)
        if dims is None:
            return None
        w, h = dims
    ptype = (rest >> (55 - pos - 2)) & 0x3
    return w, h, ptype == 0


class PoolStepResult:
    """Device-resident results of one pool decode step.

    Mapping-shaped: `result[sid]` returns that stream's (y, cb, cr) numpy
    planes — an EXPLICIT host readback, sliced on device first so only one
    stream's planes cross the link (never the whole batch plane).  A
    steady-state serving step
    that never indexes the result performs ZERO host fetches (VERDICT r2
    item 6): the batched arrays stay in HBM and the next step chains off
    them.  `device_planes(sid)` hands back the device-resident slices for
    on-device post-processing; `fetch_all()` is the bulk readback.
    """

    __slots__ = ("_entries", "_cache")

    def __init__(self):
        self._entries: dict = {}  # sid -> (y, cb, cr batched dev arrays, slot)
        self._cache: dict = {}

    def _add(self, sid, y, cb, cr, slot: int) -> None:
        self._entries[sid] = (y, cb, cr, slot)

    def device_planes(self, sid):
        """(y, cb, cr) as device-resident jax arrays for one stream."""
        y, cb, cr, slot = self._entries[sid]
        return y[slot], cb[slot], cr[slot]

    def __getitem__(self, sid):
        got = self._cache.get(sid)
        if got is None:
            incr("pool_host_fetches")
            y, cb, cr = self.device_planes(sid)
            got = (np.asarray(y), np.asarray(cb), np.asarray(cr))
            self._cache[sid] = got
        return got

    def fetch_all(self) -> dict:
        """{sid: (y, cb, cr) numpy} for every decoded stream (bulk
        readback; one sliced fetch per stream)."""
        return {sid: self[sid] for sid in self._entries}

    def __contains__(self, sid):
        return sid in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        """(sid, (y, cb, cr) numpy) pairs — explicit per-stream fetches.

        Materialized (not a generator) so repeated iteration behaves like
        the Mapping API this class advertises; each call re-fetches."""
        return [(sid, self[sid]) for sid in self._entries]

    def values(self):
        return [self[sid] for sid in self._entries]


class StreamPool:
    """Decode many streams of mixed resolutions with dynamic membership.

    Usage:
        pool = StreamPool()
        pool.add_stream("a", 352, 288)
        pool.add_stream("b", 176, 144)
        planes = pool.decode_step({"a": buf_a, "b": buf_b})
        planes["a"]                    # -> (y, cb, cr) numpy (explicit fetch)
        planes.device_planes("a")      # -> device-resident, no readback
        pool.remove_stream("b")        # slot recycled
        pool.add_stream("c", 176, 144) # reuses b's slot, fresh state

    Results are device-resident (PoolStepResult): nothing crosses the
    host<->device link unless explicitly indexed/fetched.
    """

    def __init__(self, decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 frontend: str = "host", max_dims: tuple = (2048, 2048),
                 adaptive_frontend: bool = False, degrade_ratio: float = 8.0,
                 adapt_min_samples: int = 8, **decoder_kwargs):
        """`frontend` selects each bucket's decoder: "host" (the default
        BatchedStreamDecoder — host entropy parse, packed transports) or
        "device" (DeviceFrontendDecoder — the device entropy automaton).
        `max_dims` bounds the resolutions a mid-stream change may create:
        a bucket's reference planes and compiled program are sized by its
        dims, so an unchecked (possibly corrupt) header must not be able
        to allocate a 65535x65535 bucket or churn compiles — frames beyond
        the bound fail per-stream instead.  `decoder_kwargs` pass through
        to the bucket decoders (filtered per decoder class, so host-only
        kwargs survive a frontend switch).

        `adaptive_frontend`: switch host->device live when the observed
        transfer bandwidth collapses `degrade_ratio`x below the best
        window seen over >= `adapt_min_samples` steps (see module
        docstring).  Sorenson pools only: the automaton covers that
        bitstream fully (standard streams can carry GOBs / MODIFIED_
        QUANTIZATION, which are host front-end work)."""
        if frontend not in ("host", "device"):
            raise ValueError(f"unknown frontend {frontend!r}")
        if adaptive_frontend and not (
                decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM):
            raise ValueError("adaptive_frontend requires a Sorenson pool "
                             "(the device front-end covers that bitstream "
                             "fully)")
        self.decoder_options = decoder_options
        self.frontend = frontend
        self.max_dims = max_dims
        self.adaptive_frontend = adaptive_frontend
        self.degrade_ratio = float(degrade_ratio)
        self.adapt_min_samples = int(adapt_min_samples)
        self.decoder_kwargs = decoder_kwargs
        self._pending: dict = {}          # (w, h) -> [stream_id, ...]
        self._pending_running: dict = {}  # stream_id -> carried options
        self._buckets: dict = {}          # (w, h) -> _Bucket
        self._dims: dict = {}             # stream_id -> (w, h)
        # Bandwidth monitor state (EMA of bytes/s; see module docstring).
        self._bw_ema: Optional[float] = None
        self._bw_best = 0.0
        self._bw_samples = 0
        # Pluggable stats source (tests inject degraded readings here).
        self._transfer_stats_fn = (
            lambda dec: (dec.last_transfer_bytes, dec.last_transfer_s))

    def _make_decoder(self, n: int, width: int, height: int,
                      frontend: Optional[str] = None):
        import inspect

        frontend = frontend or self.frontend
        if frontend == "device":
            from .device_batch import DeviceFrontendDecoder

            cls = DeviceFrontendDecoder
        else:
            cls = BatchedStreamDecoder
        accepted = inspect.signature(cls.__init__).parameters
        kwargs = {k: v for k, v in self.decoder_kwargs.items()
                  if k in accepted}
        return cls(n, width, height, self.decoder_options, **kwargs)

    # -- membership -----------------------------------------------------------

    def add_stream(self, stream_id, width: int, height: int) -> None:
        """Register a stream (before or after decoding has started)."""
        if stream_id in self._dims:
            raise RuntimeError(f"duplicate stream id {stream_id!r}")
        key = (width, height)
        self._dims[stream_id] = key
        incr("pool_joins")
        if key in self._buckets:
            self._join(key, stream_id)
        else:
            self._pending.setdefault(key, []).append(stream_id)

    def remove_stream(self, stream_id) -> None:
        """Unregister a stream; its slot pads until recycled by a join."""
        key = self._dims.pop(stream_id)
        incr("pool_leaves")
        self._pending_running.pop(stream_id, None)
        pend = self._pending.get(key)
        if pend and stream_id in pend:
            pend.remove(stream_id)
            return
        bucket = self._buckets[key]
        slot = bucket.slots.pop(stream_id)
        self._reset_slot(bucket.dec, slot)
        bucket.free.append(slot)

    def _reset_slot(self, dec: BatchedStreamDecoder, slot: int,
                    running: Optional[PictureOption] = None) -> None:
        dec.reset_slot_state(slot, running)

    def _join(self, key, stream_id,
              running: Optional[PictureOption] = None) -> int:
        bucket = self._buckets[key]
        if not bucket.free:
            self._grow(key)
            bucket = self._buckets[key]
        slot = bucket.free.pop()
        self._reset_slot(bucket.dec, slot, running)
        bucket.slots[stream_id] = slot
        return slot

    def _finalize(self, key):
        ids = self._pending.pop(key)
        dec = self._make_decoder(len(ids), key[0], key[1])
        bucket = _Bucket(dec)
        self._buckets[key] = bucket
        for sid in ids:
            slot = bucket.free.pop()
            bucket.slots[sid] = slot
            running = self._pending_running.pop(sid, None)
            if running is not None:  # carried across a pending rebucket
                dec.reset_slot_state(slot, running)

    def _grow(self, key) -> None:
        """Double a full bucket's capacity, migrating states + ref planes.

        One recompile per growth (the batched program's stream dim is
        static); slot indices are preserved so outputs stay stable.
        """
        import jax.numpy as jnp

        old = self._buckets[key]
        n_new = max(2 * old.dec.n, 1)
        dec = self._make_decoder(n_new, key[0], key[1])
        if self.frontend == "device":
            n_old = old.dec.n
            dec._pictures[:n_old] = old.dec._pictures
            dec._running[:n_old] = old.dec._running
            dec._last_buffers[:n_old] = old.dec._last_buffers
            dec._last_quant[:n_old] = old.dec._last_quant
            dec._last_deblock[:n_old] = old.dec._last_deblock
            if old.dec.last_status is not None:
                # Keep pre-growth statuses visible so an overflow flagged
                # by the step right before the growth stays repairable.
                dec.last_status = jnp.pad(old.dec.last_status,
                                          (0, n_new - n_old))
        else:
            for i, st in enumerate(old.dec.states):
                dec.states[i] = st
            dec._std_prev_fmt[:old.dec.n] = old.dec._std_prev_fmt
            dec._mv_full = old.dec._mv_full
        pad = [(0, n_new - old.dec.n)] + [(0, 0)] * (old.dec.ref_y.ndim - 1)
        dec.ref_y = jnp.pad(old.dec.ref_y, pad)
        dec.ref_cb = jnp.pad(old.dec.ref_cb, pad)
        dec.ref_cr = jnp.pad(old.dec.ref_cr, pad)
        bucket = _Bucket(dec)
        bucket.slots = dict(old.slots)
        bucket.free = [i for i in range(n_new)[::-1]
                       if i not in set(old.slots.values())]
        self._buckets[key] = bucket

    # -- resolution change ----------------------------------------------------

    def _sniff(self, stream_id, buf: bytes):
        """(w, h, is_iframe) of the frame, or None if unparseable."""
        if self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
            return _sniff_sorenson(bytes(buf))
        # Fast path: resolution changes are rare, but this pre-pass runs
        # for every present stream every step — a full Python
        # decode_picture per stream would roughly double the step's host
        # budget at S=256 (Python per-frame work matters).  A
        # pure bit-probe answers the common "dims unchanged" case; any
        # ambiguity (custom formats, malformed PSC) and any probed CHANGE
        # fall through to the full parse (the rebucket path wants exact
        # dims + picture type anyway).
        if _sniff_standard_probe(bytes(buf),
                                 self._dims[stream_id]) == "unchanged":
            w, h = self._dims[stream_id]
            return w, h, False  # is_iframe unused when dims match
        from ..parser.picture import decode_picture

        key = self._dims[stream_id]
        bucket = self._buckets.get(key)
        last = None
        if bucket is not None and stream_id in bucket.slots:
            slot = bucket.slots[stream_id]
            states = getattr(bucket.dec, "states", None)
            last = (states[slot].last_header if states is not None
                    else bucket.dec._pictures[slot])
        try:
            pic = decode_picture(BitReader(bytes(buf)), self.decoder_options,
                                 last)
        except Exception:
            return None
        if pic is None:
            return None
        fmt = pic.format or (last.format if last else None)
        wh = fmt.width_and_height() if fmt else None
        if wh is None:
            return None
        return wh[0], wh[1], pic.picture_type is PictureTypeCode.I_FRAME

    def _validate_rebucket_frame(self, buf: bytes, w: int, h: int) -> bool:
        """Full entropy-layer validation of a resolution-change frame
        BEFORE the old slot's state is destroyed (the reference's
        whole-picture transaction contract, state.rs:119-137: an errored
        picture must leave state untouched).  Resolution changes are rare,
        so a one-off host parse is cheap insurance against a frame whose
        header sniffs fine but whose MB layer is garbage."""
        from ..parser.frame import parse_frame_auto
        from ..parser.picture import decode_picture

        try:
            r = BitReader(bytes(buf))
            pic = decode_picture(r, self.decoder_options, None)
            if pic is None:
                return False
            fd = parse_frame_auto(r, pic, self.decoder_options, pic.options,
                                  w, h)
            # Decoder-level rule on top of the entropy parse: the rebucket
            # frame has NO reference at the new size, so any INTER MB
            # (e.g. EOF tail-fill from a truncated payload) would raise
            # UncodedIFrameBlocks in the bucket — after the old state was
            # already destroyed.  Reject it here instead.
            return not fd.inter.any()
        except Exception:
            return False

    def _rebucket(self, stream_id, new_key, is_iframe: bool,
                  buf: bytes = None) -> None:
        old_key = self._dims[stream_id]
        incr("pool_rebuckets")
        if not is_iframe:
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: {old_key} -> {new_key} resolution "
                f"change on a non-I frame (no reference at the new size)")
        mw, mh = self.max_dims
        if not (0 < new_key[0] <= mw and 0 < new_key[1] <= mh):
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: resolution {new_key} outside the "
                f"pool bound {self.max_dims} (would size a bucket's "
                f"planes and compiled program from an untrusted header)")
        pend = self._pending.get(old_key)
        if pend and stream_id in pend:  # registered but never decoded
            pend.remove(stream_id)
            self._dims[stream_id] = new_key
            if new_key in self._buckets:
                self._join(new_key, stream_id,
                           self._pending_running.pop(stream_id, None))
            else:
                self._pending.setdefault(new_key, []).append(stream_id)
            return
        if buf is not None and not self._validate_rebucket_frame(
                bytes(buf), new_key[0], new_key[1]):
            raise PictureFormatInvalid(
                f"stream {stream_id!r}: {old_key} -> {new_key} I-frame "
                f"failed full validation; keeping the stream's state")
        bucket = self._buckets[old_key]
        slot = bucket.slots.pop(stream_id)
        # Carry running options across the rebucket (standard H.263 only;
        # Sorenson headers are self-contained).  Both front-ends track
        # them: batched in states[].running_options, device in _running.
        states = getattr(bucket.dec, "states", None)
        if states is not None:
            running = states[slot].running_options
        else:
            running = getattr(bucket.dec, "_running", [None] * (slot + 1))[slot]
        self._reset_slot(bucket.dec, slot)
        bucket.free.append(slot)
        self._dims[stream_id] = new_key
        if new_key in self._buckets:
            self._join(new_key, stream_id, running)
        else:
            if running:
                self._pending_running[stream_id] = running
            self._pending.setdefault(new_key, []).append(stream_id)

    # -- decode ---------------------------------------------------------------

    def decode_step(self, buffers: dict) -> PoolStepResult:
        """Decode one frame for each stream present in `buffers`.

        Registered streams absent from `buffers` keep their state and
        planes (their slots pad with skip frames).  A stream whose frame
        is an I-frame at new dimensions is rebucketed first.  Returns a
        PoolStepResult mapping stream_id -> (y, cb, cr): device-resident
        until explicitly indexed (zero host fetches in steady state).
        """
        unknown = set(buffers) - set(self._dims)
        if unknown:
            # key=repr: ids may mix int and str (not mutually orderable).
            raise KeyError(
                f"unregistered streams: {sorted(unknown, key=repr)!r}")

        # Resolution-change pre-pass: move streams whose header disagrees
        # with their bucket before building the lockstep batches.
        for sid, buf in list(buffers.items()):
            sniffed = self._sniff(sid, buf)
            if sniffed is None:
                continue  # let the bucket parser raise the precise error
            w, h, is_i = sniffed
            if (w, h) != self._dims[sid]:
                self._rebucket(sid, (w, h), is_i, buf)

        for key in list(self._pending):
            self._finalize(key)

        out = PoolStepResult()
        first_err: Optional[H263Error] = None
        step_bytes = 0
        step_seconds = 0.0
        for key, bucket in self._buckets.items():
            dec = bucket.dec
            mask = bucket.mask(buffers)
            if not mask.any():
                continue
            batch = [None] * dec.n
            for sid, slot in bucket.slots.items():
                if mask[slot]:
                    batch[slot] = buffers[sid]
            try:
                y, cb, cr = dec.decode_step(batch, mask=mask)
                nb, s = self._transfer_stats_fn(dec)
                step_bytes += nb
                step_seconds += s
            except H263Error as e:
                # Per-stream isolation, pool-wide: the bucket decoder has
                # already stepped every lane (errored lanes got identity
                # frames) before raising, so SKIPPING the remaining
                # buckets — or letting the caller retry the whole step —
                # would corrupt healthy streams.  Step everything, then
                # surface the first error (partial results attached).
                if first_err is None:
                    first_err = e
                continue
            for sid, slot in bucket.slots.items():
                if mask[slot]:
                    out._add(sid, y, cb, cr, slot)
        if self.adaptive_frontend and self.frontend == "host":
            self._note_transfer(step_bytes, step_seconds)
        if first_err is not None:
            first_err.pool_step_result = out
            raise first_err
        return out

    def decode_steps(self, frame_lists) -> list:
        """Decode a WINDOW of T frames (`frame_lists`: T dicts of
        stream_id -> frame bytes) with ONE device dispatch per bucket per
        window — the K-frame megastep (DeviceFrontendDecoder.decode_steps;
        one ragged transfer leaf and one lax.scan program run per K
        frames, amortizing the per-call host floor of single-frame
        serving).

        Returns a list of T PoolStepResult — frame t's entries hold the
        same planes T sequential decode_step calls would have produced
        (pinned differentially by the pool window tests).  Semantics
        match T decode_step calls exactly:

        * registered streams absent from a frame's dict decode the skip
          frame with header commit suppressed;
        * failed (frame, lane)s decode identity frames and the FIRST
          error is raised after every bucket has stepped, with
          `pool_window_results` attached;
        * mid-window ST_TAPE_OVERFLOW is repaired by resolve_overflows()
          at the next sync point (it delegates to window-granularity
          replay while a window is pending).

        Falls back to T sequential decode_step calls — identical results,
        just without the dispatch amortization — when the pool's
        front-end is "host" (BatchedStreamDecoder has no window step),
        when a bucket lacks the ragged payload (no native prep), or when
        any frame in the window would rebucket a stream (resolution
        changes need the per-frame pre-pass).
        """
        T = len(frame_lists)
        if T == 0:
            return []
        unknown = set()
        for b in frame_lists:
            unknown |= set(b) - set(self._dims)
        if unknown:
            raise KeyError(
                f"unregistered streams: {sorted(unknown, key=repr)!r}")

        def sequential():
            return [self.decode_step(b) for b in frame_lists]

        if self.frontend != "device":
            return sequential()
        for b in frame_lists:
            for sid, buf in b.items():
                sniffed = self._sniff(sid, buf)
                if (sniffed is not None
                        and (sniffed[0], sniffed[1]) != self._dims[sid]):
                    return sequential()  # mid-window resolution change
        for key in list(self._pending):
            self._finalize(key)
        if any(getattr(b.dec, "payload", None) != "ragged"
               for b in self._buckets.values() if b.slots):
            return sequential()

        results = [PoolStepResult() for _ in range(T)]
        first_err: Optional[H263Error] = None
        for key, bucket in self._buckets.items():
            dec = bucket.dec
            window = []
            any_present = False
            for b in frame_lists:
                batch = [None] * dec.n
                for sid, slot in bucket.slots.items():
                    if sid in b:
                        batch[slot] = b[sid]
                        any_present = True
                window.append(batch)
            if not any_present:
                continue
            try:
                ys, cbs, crs = dec.decode_steps(window)
            except H263Error as e:
                # Same per-stream isolation as decode_step: the window
                # dispatched (failed lanes decode identity frames) before
                # raising, so the remaining buckets must still step; this
                # bucket's per-frame planes are simply not attached.
                if first_err is None:
                    first_err = e
                continue
            for t in range(T):
                for sid, slot in bucket.slots.items():
                    if sid in frame_lists[t]:
                        results[t]._add(sid, ys[t], cbs[t], crs[t], slot)
        if first_err is not None:
            first_err.pool_window_results = results
            raise first_err
        return results

    # -- degraded-window adaptation (module docstring) ----------------------

    def _note_transfer(self, nbytes: int, seconds: float) -> None:
        """Feed one step's aggregate transfer cost to the bandwidth EMA;
        trigger the host->device frontend switch when the window degrades
        `degrade_ratio`x below the best EMA seen."""
        if nbytes < 1024 or seconds <= 0:
            return  # too small to estimate bandwidth
        bw = nbytes / seconds
        alpha = 0.3
        self._bw_ema = (bw if self._bw_ema is None
                        else alpha * bw + (1 - alpha) * self._bw_ema)
        self._bw_samples += 1
        if self._bw_samples < self.adapt_min_samples:
            return
        self._bw_best = max(self._bw_best, self._bw_ema)
        if self._bw_ema < self._bw_best / self.degrade_ratio:
            incr("pool_degraded_window_detected")
            self.switch_frontend("device")

    def switch_frontend(self, frontend: str) -> None:
        """Switch every bucket's decoder to `frontend` live, transplanting
        reference planes (device-resident; no host readback) and carried
        per-stream header state.  Host->device only: the reverse would
        need per-slot has_reference / disposable-frame nuances the device
        path does not track.  Sorenson pools only (see __init__)."""
        if frontend == self.frontend:
            return
        if frontend != "device":
            raise ValueError("switch_frontend supports host->device only")
        if not (self.decoder_options
                & DecoderOption.SORENSON_SPARK_BITSTREAM):
            raise ValueError("frontend switch requires a Sorenson pool")
        for key, bucket in self._buckets.items():
            old = bucket.dec
            new = self._make_decoder(old.n, key[0], key[1],
                                     frontend="device")
            # The old decoder's outputs gate any in-flight device_put of
            # its staging buffers; transplanting them keeps the dependency
            # graph alive, but block anyway so the swap is a sync point.
            old.ref_y.block_until_ready()
            new.ref_y, new.ref_cb, new.ref_cr = (old.ref_y, old.ref_cb,
                                                 old.ref_cr)
            for i in range(old.n):
                st = old.states[i]
                new._pictures[i] = st.last_header
                new._running[i] = st.running_options
                if st.last_header is not None:
                    new._last_quant[i] = st.last_header.quantizer
                    new._last_deblock[i] = bool(
                        st.last_header.options & PictureOption.USE_DEBLOCKER)
            bucket.dec = new
            incr("pool_frontend_switches")
        self.frontend = frontend

    def resolve_overflows(self, result: Optional[PoolStepResult] = None) -> list:
        """Device-frontend pools only: repair lanes whose last step hit
        ST_TAPE_OVERFLOW (DeviceFrontendDecoder.resolve_overflows) across
        all buckets.  A sync point — call between steps, not per frame.

        The repair lands in each bucket decoder's reference planes (the
        next step / present_rgba see it); the arrays inside an
        already-returned PoolStepResult are immutable, so pass that step's
        `result` to have the repaired sids' entries re-pointed at the
        fixed planes.  Returns the repaired stream ids."""
        if self.frontend != "device":
            return []
        out = []
        for bucket in self._buckets.values():
            repaired = set(bucket.dec.resolve_overflows())
            for sid, slot in bucket.slots.items():
                if slot not in repaired:
                    continue
                out.append(sid)
                if result is not None and sid in result:
                    result._add(sid, bucket.dec.ref_y, bucket.dec.ref_cb,
                                bucket.dec.ref_cr, slot)
                    result._cache.pop(sid, None)
        return out

    def present_rgba(self, deblock: Optional[bool] = None) -> dict:
        """Device-resident RGBA for every registered stream's last decoded
        frame: {sid: jax array [H, W, 4]} — sliced per stream on device;
        fetch with np.asarray only when the pixels are actually needed
        host-side (each fetch crosses the link for one stream only)."""
        out = {}
        for key, bucket in self._buckets.items():
            if not bucket.slots:
                continue
            rgba = bucket.dec.present_rgba(deblock)
            for sid, slot in bucket.slots.items():
                out[sid] = rgba[slot]
        return out
