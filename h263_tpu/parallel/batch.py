"""Batched multi-stream decoder.

Decodes N concurrent streams of one resolution bucket as a single device
program per frame step.  Host entropy decode runs per stream (serial by
nature); the dense tensors are stacked along the leading stream axis and the
whole batch reconstructs in one jitted XLA call, with reference planes kept
device-resident between frames.

Per-stream header state (running options, TR bookkeeping, reference rules)
follows H263State semantics exactly — see decoder/state.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..bitio import BitReader
from ..utils.trace import StageTimer, incr, trace_stage
from ..decoder.reconstruct import (
    check_pallas,
    get_batched_reconstruct_fn,
    get_packed_d24_reconstruct_fn,
    get_packed_split_reconstruct_fn,
    get_packed_u32_reconstruct_fn,
)
from ..parser.frame import FrameData, parse_frame_auto
from ..parser.picture import decode_picture
from ..types import (
    DecoderOption,
    MiddleOfBitstream,
    MPPTYPE_OPTIONS,
    OPPTYPE_OPTIONS,
    Picture,
    PictureFormatInvalid,
    PictureFormatMissing,
    PictureOption,
    PictureTypeCode,
    UncodedIFrameBlocks,
)


def _picture_from_fields(hdr) -> Picture:
    """Build a Picture from the native fast-parse header fields
    [version, tr, w, h, ptype, deblocker, quant, fmt_code]."""
    from ..types import (
        MotionVectorRange,
        PictureTypeCode as PTC,
        SourceFormat,
        SourceFormatKind,
    )

    fmt_code = int(hdr[7])
    w, h = int(hdr[2]), int(hdr[3])
    if fmt_code == 2:
        fmt = SourceFormat(SourceFormatKind.FULL_CIF)
    elif fmt_code == 3:
        fmt = SourceFormat(SourceFormatKind.QUARTER_CIF)
    elif fmt_code == 4:
        fmt = SourceFormat(SourceFormatKind.SUB_QCIF)
    else:
        fmt = SourceFormat.extended(w, h)
    ptype = (PTC.I_FRAME, PTC.P_FRAME, PTC.DISPOSABLE_P_FRAME,
             PTC.RESERVED)[int(hdr[4])]
    return Picture(
        version=int(hdr[0]),
        temporal_reference=int(hdr[1]),
        format=fmt,
        options=(PictureOption.USE_DEBLOCKER if hdr[5] else PictureOption.NONE),
        picture_type=ptype,
        quantizer=int(hdr[6]),
        motion_vector_range=MotionVectorRange.UNLIMITED,
    )


class _StreamState:
    __slots__ = ("running_options", "last_header", "has_reference")

    def __init__(self):
        self.running_options = PictureOption.NONE
        self.last_header: Optional[Picture] = None
        self.has_reference = False


class _HostBatch:
    """Preallocated pinned host buffers for one batched frame step.

    The native front-end writes each stream's tensors straight into its
    slice (no per-stream allocation, no np.stack), and the whole set ships
    to the device in one transfer.
    """

    def __init__(self, n, mb_w, mb_h):
        self.coeffs_y = np.zeros((n, 2 * mb_h, 2 * mb_w, 8, 8), dtype=np.int16)
        self.class_y = np.zeros((n, 2 * mb_h, 2 * mb_w), dtype=np.int8)
        self.coeffs_cb = np.zeros((n, mb_h, mb_w, 8, 8), dtype=np.int16)
        self.class_cb = np.zeros((n, mb_h, mb_w), dtype=np.int8)
        self.coeffs_cr = np.zeros((n, mb_h, mb_w, 8, 8), dtype=np.int16)
        self.class_cr = np.zeros((n, mb_h, mb_w), dtype=np.int8)
        self.mvs = np.zeros((n, mb_h, mb_w, 4, 2), dtype=np.int16)
        self.inter = np.ones((n, mb_h, mb_w), dtype=np.uint8)
        # Device outputs of the step that last consumed these buffers (see
        # BatchedStreamDecoder.next_host_batch).
        self.in_flight = None

    def slice_of(self, i):
        return (self.coeffs_y[i], self.class_y[i], self.coeffs_cb[i],
                self.class_cb[i], self.coeffs_cr[i], self.class_cr[i],
                self.mvs[i], self.inter[i])

    def tensors(self):
        return (self.coeffs_y, self.class_y, self.coeffs_cb, self.class_cb,
                self.coeffs_cr, self.class_cr, self.mvs, self.inter)


class _PackedBatch:
    """Host buffers for the packed coefficient transport.

    Coefficients ride as one uint32 each — (pos << 12) | (value & 0xFFF) —
    cutting host->device bytes by ~100x vs the dense transport on typical
    streams.  Per-stream coefficient counts let the step slice the transfer
    to a bucketed maximum instead of shipping the full capacity."""

    def __init__(self, n, mb_w, mb_h, cap, split=False, transport="u32"):
        # transport "u32": combined-u32 (4 B/coeff, needs 20-bit positions).
        # "split": int32 position + int16 value arrays (6 B/coeff, any
        # picture size).  "d24": delta-coded 24-bit entries (3 B/coeff, any
        # picture size) — self.u32 is then a uint8 [n, 3*cap] buffer.
        self.transport = "split" if split else transport
        self.split = split
        if self.transport == "d24":
            self.u32 = np.zeros((n, 3 * cap), dtype=np.uint8)
        else:
            self.u32 = np.zeros((n, cap), dtype=np.int32)
        self.val = np.zeros((n, cap), dtype=np.int16) if split else None
        self.mvs = np.zeros((n, mb_h, mb_w, 4, 2), dtype=np.int16)
        # Contiguous first-block MVs, filled natively: the slim transport
        # ships this directly (no per-step strided gather).
        self.mvs_slim = np.zeros((n, mb_h, mb_w, 2), dtype=np.int16)
        self.inter = np.ones((n, mb_h, mb_w), dtype=np.uint8)
        self.counts = np.zeros(n, dtype=np.int64)
        self.varied_mvs = np.zeros(n, dtype=np.bool_)
        self.fast_parsers = None  # lazily bound SorensonFastParser per slot
        self.batch_parser = None  # lazily bound SorensonBatchParser
        self.std_parser = None    # lazily bound StandardBatchParser
        # Fused single-leaf transport (Sorenson + d24): per-stream staging
        # rows [int8 MVs | INTER bitmask | d24 bytes], written natively.
        self.fused = None         # uint8 [n, row] staging (lazily allocated)
        self.fused_mv_stride = 0  # 2 (slim) or 8 (full) int8 MV bytes per MB
        self.fused_parser = None  # lazily bound SorensonFusedBatchParser
        self.fused_valid = False  # this batch's staging holds the last parse
        self.cut = 0              # native-chosen coefficient bucket
        # Device outputs of the step that last consumed these buffers, and
        # the pipeline future that will produce them (see next_packed_batch
        # / submit_step).
        self.in_flight = None
        self.fut = None


class BatchedStreamDecoder:
    """Decode S same-resolution streams in lockstep, one frame per step.

    This is the throughput configuration from BASELINE.json config 4: all
    streams' macroblocks run through shared batched kernels.
    """

    def __init__(self, n_streams: int, width: int, height: int,
                 decoder_options: DecoderOption = DecoderOption.SORENSON_SPARK_BITSTREAM,
                 reconstruct_fn=None, packed_reconstruct_fn=None,
                 pack_cap: Optional[int] = None, pallas: str = "auto",
                 coef_transport: str = "auto",
                 fused_reconstruct_fns: Optional[dict] = None):
        import jax.numpy as jnp

        check_pallas(pallas)

        self.n = n_streams
        self.w = width
        self.h = height
        self.cw = (width + 1) // 2
        self.ch = (height + 1) // 2
        self.decoder_options = decoder_options
        self.states = [_StreamState() for _ in range(n_streams)]
        # Last step's host->device payload cost, always-on (cheap): the
        # pool's degraded-window monitor reads these after every step.
        self.last_transfer_s = 0.0
        self.last_transfer_bytes = 0
        self.ref_y = jnp.zeros((n_streams, self.h, self.w), dtype=jnp.uint8)
        self.ref_cb = jnp.zeros((n_streams, self.ch, self.cw), dtype=jnp.uint8)
        self.ref_cr = jnp.zeros((n_streams, self.ch, self.cw), dtype=jnp.uint8)
        self._fn = reconstruct_fn or get_batched_reconstruct_fn(self.h, self.w)
        mb_w, mb_h = -(-width // 16), -(-height // 16)
        self.mb_w, self.mb_h = mb_w, mb_h
        # Ping-pong host batches so a transfer can be in flight while the
        # next frame parses.
        self._batches = [_HostBatch(n_streams, mb_w, mb_h) for _ in range(2)]
        self._batch_idx = 0
        # Packed transport: (position, value) coefficient pairs.  Capacity
        # defaults to 16 coefficients per macroblock (typical streams use
        # 2-8); PackOverflow falls back to the dense transport per step.
        self.pack_cap = pack_cap or max(1024, 16 * mb_w * mb_h)
        # Transfer-size ladder: typical P frames fit the tiny bucket
        # (~1.5 coefficients/MB incl. delta24 escapes), busier frames the
        # small one, everything else ships full capacity.  Three fixed
        # signatures keep the jit cache bounded; each compiles lazily on
        # first use.
        self.pack_cap_small = max(512, 4 * mb_w * mb_h)
        if self.pack_cap_small >= self.pack_cap:
            self.pack_cap_small = self.pack_cap
        self.pack_cap_tiny = max(256, (3 * mb_w * mb_h) // 2)
        if self.pack_cap_tiny >= self.pack_cap_small:
            self.pack_cap_tiny = self.pack_cap_small
        # Ascending unique bucket ladder (ends at full capacity); the fused
        # native batch picks the cut from this and pads d24 tails to it.
        self._ladder = np.array(
            sorted({self.pack_cap_tiny, self.pack_cap_small, self.pack_cap}),
            dtype=np.int32)
        self._mv_full = False  # sticky: set on first frame with varied MVs
        self._executor = None  # lazy pipeline worker (submit_step)
        self._skip_frame: Optional[bytes] = None  # lazy all-uncoded P-frame
        # Standard-H.263 native fast path: each stream's previous PTYPE
        # format code (-1 none, -2 non-PTYPE header — punts to Python).
        self._std_prev_fmt = np.full(n_streams, -1, dtype=np.int32)
        self._pred_scratch = np.zeros((mb_w * mb_h, 4, 2), dtype=np.int16)
        # Header-commit fast path: Picture objects cached per unique native
        # header row, and PictureOption enums per running-options value, so
        # the per-stream commit loop is dict lookups + int arithmetic.
        self._pic_cache: dict = {}
        self._po_cache: dict = {}
        # Coefficient transport: "d24" delta-coded 3 B/coeff (any picture
        # size — the production default: fewest transfer bytes, measured
        # fastest and tightest-variance on hardware), "u32" combined
        # 4 B/coeff (20-bit position limit, < ~2730 macroblocks), "split"
        # 6 B/coeff (any size).
        if coef_transport == "auto":
            coef_transport = "d24"
        if coef_transport not in ("u32", "split", "d24"):
            raise ValueError(f"coef_transport must be 'auto', 'u32', "
                             f"'split', or 'd24'; got {coef_transport!r}")
        if coef_transport == "u32" and 6 * mb_w * mb_h * 64 >= (1 << 20):
            raise ValueError("picture too large for the combined-u32 "
                             "transport; use 'split' or 'd24'")
        self.coef_transport = coef_transport
        self._split = coef_transport == "split"
        # Fused single-leaf transport: the production default for Sorenson
        # d24 batches (one device_put of [mv8 | interbits | d24] rows per
        # step — ~30% fewer bytes, 2 fewer copies).  H263_TPU_NO_FUSED
        # forces the three-leaf path for A/B.
        import os as _os

        self._fused_enabled = (
            coef_transport == "d24"
            and bool(decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM)
            and not _os.environ.get("H263_TPU_NO_FUSED")
            # An explicitly injected packed program (e.g. a mesh-sharded
            # one) is honoured: fused stays off unless matching fused
            # programs were injected too ({False: fn, True: fn} by MV mode).
            and (packed_reconstruct_fn is None
                 or fused_reconstruct_fns is not None))
        if fused_reconstruct_fns is not None and set(
                fused_reconstruct_fns) != {False, True}:
            # Both MV row layouts must be covered: the slim->full flip
            # would otherwise silently fall back to a locally-built
            # (unsharded) program mid-stream.
            raise ValueError(
                "fused_reconstruct_fns must provide both MV modes "
                f"{{False, True}}; got {set(fused_reconstruct_fns)!r}")
        if fused_reconstruct_fns is not None and packed_reconstruct_fn is None:
            # The slim->full MV flip step re-ships that one frame over the
            # legacy three-leaf packed path; without an injected packed
            # program it would dispatch a locally-built (unsharded) jit
            # against mesh-sharded reference planes mid-stream.
            raise ValueError(
                "fused_reconstruct_fns requires a matching "
                "packed_reconstruct_fn (the MV-flip step runs the legacy "
                "packed program for one frame)")
        self._fused_fn_cache = dict(fused_reconstruct_fns or {})
        self._packed = [_PackedBatch(n_streams, mb_w, mb_h, self.pack_cap,
                                     split=self._split,
                                     transport=coef_transport)
                        for _ in range(2)]
        self._packed_idx = 0
        if packed_reconstruct_fn is not None:
            self._packed_fn = packed_reconstruct_fn
        elif coef_transport == "d24":
            self._packed_fn = get_packed_d24_reconstruct_fn(self.h, self.w)
        elif self._split:
            self._packed_fn = get_packed_split_reconstruct_fn(self.h, self.w)
        else:
            self._packed_fn = get_packed_u32_reconstruct_fn(self.h, self.w)

    # Host transport buffers are handed to jax.device_put, which may READ
    # THEM ASYNCHRONOUSLY (accelerators: the transfer completes after the
    # call returns) or ALIAS THEM OUTRIGHT (CPU: zero-copy of aligned numpy
    # arrays).  Reusing a buffer before the step that consumed it has
    # executed therefore corrupts that step's input — observed as
    # nondeterministic decodes on the CPU backend whenever several steps
    # queue up behind a slow compile with no intervening readback.  The
    # ping-pong rotation below blocks on the consuming step's OUTPUTS
    # (outputs ready ⇒ inputs fully consumed) before handing a buffer out
    # again; steady-state that wait is long resolved and costs nothing.

    @staticmethod
    def _reclaim(buf):
        if buf.in_flight is not None:
            with trace_stage("reclaim_wait"):
                for a in buf.in_flight:
                    a.block_until_ready()
            buf.in_flight = None

    def next_host_batch(self) -> _HostBatch:
        self._batch_idx ^= 1
        batch = self._batches[self._batch_idx]
        self._reclaim(batch)
        return batch

    def next_packed_batch(self) -> "_PackedBatch":
        self._packed_idx ^= 1
        packed = self._packed[self._packed_idx]
        if packed.fut is not None:
            # Pipeline ordering: the consuming step may not have dispatched
            # yet; wait for it.  Its exception (if any) was already
            # delivered to the submitter through this same future — swallow
            # it here so a once-failed step can't poison its buffer (a
            # failed step sets no in_flight and the next parse refills the
            # buffer from scratch).
            fut, packed.fut = packed.fut, None
            with trace_stage("reclaim_fut_wait"):
                try:
                    fut.result()
                except Exception:
                    pass
        self._reclaim(packed)
        return packed

    # -- host stage -----------------------------------------------------------

    def _parse_header(self, stream_idx: int, r: BitReader):
        """Shared picture-header handling; returns (picture, running_options)."""
        st = self.states[stream_idx]
        pic = decode_picture(r, self.decoder_options, st.last_header)
        if pic is None:
            raise MiddleOfBitstream()

        from ..types import carry_forward_options

        running = carry_forward_options(pic, st.running_options)

        fmt = pic.format
        if fmt is None:
            if st.last_header is None or pic.picture_type is PictureTypeCode.I_FRAME:
                raise PictureFormatMissing()
            fmt = st.last_header.format
        wh = fmt.width_and_height()
        if wh is None or wh != (self.w, self.h):
            raise PictureFormatInvalid(
                f"stream {stream_idx}: expected {(self.w, self.h)}, got {wh}")
        return pic, running

    _STD_FMT_BITS = None  # SourceFormatKind -> PTYPE format code, lazy

    def _commit_header(self, stream_idx: int, pic: Picture,
                       running: PictureOption) -> None:
        """state.rs:464-483 header-state semantics."""
        st = self.states[stream_idx]
        if pic.picture_type is PictureTypeCode.I_FRAME:
            st.has_reference = False
        st.last_header = pic
        if not pic.picture_type.is_disposable():
            st.has_reference = True
        st.running_options = running
        if not (self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM):
            # Bookkeeping for the native PTYPE fast path's RPRP quirk check.
            from ..types import SourceFormatKind as K

            if BatchedStreamDecoder._STD_FMT_BITS is None:
                BatchedStreamDecoder._STD_FMT_BITS = {
                    K.SUB_QCIF: 1, K.QUARTER_CIF: 2, K.FULL_CIF: 3,
                    K.FOUR_CIF: 4, K.SIXTEEN_CIF: 5}
            bits = -2
            if not pic.has_plusptype and pic.format is not None:
                bits = BatchedStreamDecoder._STD_FMT_BITS.get(
                    pic.format.kind, -2)
            self._std_prev_fmt[stream_idx] = bits

    def reset_slot_state(self, slot: int,
                         running: Optional[PictureOption] = None) -> None:
        """Fresh per-stream state for a (re)joined batch slot."""
        st = self.states[slot]
        st.running_options = (running if running is not None
                              else PictureOption.NONE)
        st.last_header = None
        st.has_reference = False
        self._std_prev_fmt[slot] = -1

    def skip_frame_bytes(self) -> bytes:
        """A cached all-uncoded P-frame at this bucket's dims.

        Used to pad empty/absent slots in a lockstep batch: every
        macroblock is COD=1 (copy reference with MV 0), so the slot's
        planes are preserved and — decoded with commit suppressed — its
        header state is untouched."""
        if self._skip_frame is None:
            from ..testing.encoder import (MBSpec, encode_sorenson_picture,
                                           encode_standard_picture)

            mbs = [MBSpec(kind="uncoded")] * (self.mb_w * self.mb_h)
            enc = (encode_sorenson_picture
                   if self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM
                   else encode_standard_picture)
            self._skip_frame = enc(self.w, self.h, PictureTypeCode.P_FRAME,
                                   mbs)
        return self._skip_frame

    def parse_one(self, stream_idx: int, buf: bytes,
                  batch: Optional[_HostBatch] = None,
                  commit: bool = True, stage_commit: Optional[list] = None) -> FrameData:
        """Entropy-decode one stream's next frame to dense tensors.

        With `batch` given (and the native front-end available), tensors are
        written directly into the stream's slice of the batch buffers.
        commit=False parses without touching per-stream header state or
        enforcing the reference-picture rule (slot-padding path).  With
        `stage_commit` (a list), the header commit is APPENDED as
        (stream_idx, pic, running) instead of applied — the batch caller
        commits only after every stream parsed, so one corrupt stream
        cannot leave earlier streams' header state advanced past planes
        that were never updated (the packed path's all-or-nothing rule).
        """
        st = self.states[stream_idx]
        r = BitReader(bytes(buf))
        pic, running = self._parse_header(stream_idx, r)

        frame = None
        if batch is not None:
            import os

            if not os.environ.get("H263_TPU_NO_NATIVE"):
                from ..native import ensure_built, parse_frame_native

                if ensure_built():
                    frame, end_bit = parse_frame_native(
                        r.data, r.pos, pic, self.decoder_options, running,
                        self.w, self.h, out=batch.slice_of(stream_idx))
                    r.pos = end_bit
        if frame is None:
            frame = parse_frame_auto(r, pic, self.decoder_options, running,
                                     self.w, self.h)
            if batch is not None:
                dst = batch.slice_of(stream_idx)
                src = (frame.coeffs_y, frame.class_y, frame.coeffs_cb,
                       frame.class_cb, frame.coeffs_cr, frame.class_cr,
                       frame.mvs, frame.inter)
                for d, s in zip(dst, src):
                    d[:] = s
        if commit:
            if frame.inter.any() and not st.has_reference:
                raise UncodedIFrameBlocks()
            if stage_commit is not None:
                stage_commit.append((stream_idx, pic, running))
            else:
                self._commit_header(stream_idx, pic, running)
        return frame

    def parse_one_packed(self, stream_idx: int, buf: bytes,
                         packed: "_PackedBatch") -> int:
        """Entropy-decode one Sorenson stream's frame into the packed
        transport (full-native hot path: header + macroblocks in one C++
        call through pre-marshalled per-slot buffers).

        Raises PackOverflow when the frame has more coefficients than the
        batch capacity (caller falls back to the dense path).  Returns the
        coefficient count.
        """
        assert self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM, \
            "packed transport is the Sorenson hot path; use dense otherwise"
        assert packed.transport == "u32", \
            "the per-slot fast parser supports the u32 transport only"
        st = self.states[stream_idx]
        data = bytes(buf)

        parser = self._fast_parser(packed, stream_idx)
        hdr, n, any_inter, varied = parser.parse(data)
        if any_inter and not st.has_reference:
            raise UncodedIFrameBlocks()
        packed.counts[stream_idx] = n
        packed.varied_mvs[stream_idx] = varied
        # The per-slot native parser fills only the full int16 MV rows
        # (its mvs_slim pointer is unbound); derive the slim one-MV-per-MB
        # row here — step_packed ships mvs_slim whenever the sticky
        # full-MV mode is off, and an unwritten row would motion-compensate
        # with zero/stale vectors.
        packed.mvs_slim[stream_idx] = packed.mvs[stream_idx, :, :, 0, :]
        from ..types import carry_forward_options

        pic = _picture_from_fields(hdr)
        running = carry_forward_options(pic, st.running_options)
        self._commit_header(stream_idx, pic, running)
        return n

    def _fast_parser(self, packed: "_PackedBatch", stream_idx: int):
        from ..native import ensure_built
        from ..native.bindings import SorensonFastParser

        if packed.fast_parsers is None:
            if not ensure_built():
                raise RuntimeError(
                    "packed transport requires the native front-end")
            packed.fast_parsers = [
                SorensonFastParser(self.w, self.h, packed.u32[i],
                                   packed.mvs[i],
                                   packed.inter[i], self._pred_scratch)
                for i in range(self.n)
            ]
        return packed.fast_parsers[stream_idx]

    def parse_batch_packed_standard(self, buffers: Sequence[bytes],
                                    packed: "_PackedBatch",
                                    mask=None) -> None:
        """Packed-transport batch parse for standard (non-Sorenson) H.263.

        Fast path: plain-PTYPE headers + macroblock data all parse in ONE
        native call (h263_standard_decode_batch), same as the Sorenson
        path.  Any header outside that shape (PLUSPTYPE chain, PB frames,
        reserved formats, malformed bits) aborts the native call before
        any commit and the batch replays below through the exact Python
        header parser — error classes and option semantics are identical.
        """
        from ..native.bindings import (NeedsPythonHeader,
                                       parse_frame_native_packed)

        packed.fused_valid = False
        bufs = []
        for i, b in enumerate(buffers):
            live = mask is None or mask[i]
            bufs.append((b if type(b) is bytes else bytes(b)) if live
                        else self.skip_frame_bytes())
        try:
            return self._parse_std_native(bufs, packed, mask)
        except NeedsPythonHeader:
            pass

        cap = packed.u32.shape[1]
        sentinel = 6 * self.mb_w * self.mb_h * 64
        # Wrap to int32 exactly like entropy.cpp's
        # (int32_t)((uint32_t)sentinel << 12): for >=1366 MBs the shifted
        # value exceeds int32 and numpy 2.x raises OverflowError on
        # assignment of the raw Python int.
        shifted = (sentinel << 12) & 0xFFFFFFFF
        if shifted >= 1 << 31:
            shifted -= 1 << 32
        pad = sentinel if packed.split else shifted
        staged = []
        for i, b in enumerate(bufs):
            live = mask is None or mask[i]
            r = BitReader(b)
            pic, running = self._parse_header(i, r)
            count, _ = parse_frame_native_packed(
                r.data, r.pos, pic, self.decoder_options, running,
                self.w, self.h, packed.u32[i], packed.mvs[i],
                packed.inter[i], self._pred_scratch,
                pack_val=packed.val[i] if packed.split else None,
                transport=packed.transport, mvs_slim=packed.mvs_slim[i])
            if (live and not self.states[i].has_reference
                    and packed.inter[i].any()):
                # gather.rs:149 — INTER macroblocks with no reference picture
                raise UncodedIFrameBlocks(f"stream {i}: no reference picture")
            if packed.transport == "d24":
                packed.u32[i, 3 * count:cap] = 0  # advance-0/value-0 padding
            else:
                packed.u32[i, count:cap] = pad
            packed.counts[i] = count
            staged.append((pic, running) if live else None)
        m = packed.mvs
        packed.varied_mvs[:] = (m != m[:, :, :, 0:1, :]).any(axis=(1, 2, 3, 4))
        for i, st in enumerate(staged):
            if st is not None:
                self._commit_header(i, *st)

    _STD_KIND_BY_BITS = None

    def _parse_std_native(self, bufs, packed: "_PackedBatch", mask) -> None:
        """One-FFI-call standard batch (PTYPE-only headers).

        Raises NeedsPythonHeader (atomically, nothing committed) when any
        stream's header needs the full Python parser."""
        from ..native import ensure_built
        from ..native.bindings import StandardBatchParser

        if packed.std_parser is None:
            if not ensure_built():
                raise RuntimeError(
                    "packed transport requires the native front-end")
            packed.std_parser = StandardBatchParser(
                self.n, self.w, self.h, packed.u32, packed.mvs,
                packed.inter, self._pred_scratch, pack_val=packed.val,
                transport=packed.transport, mvs_slim=packed.mvs_slim)
        p = packed.std_parser
        has_ref = [True] * self.n
        for i, st in enumerate(self.states):
            live = mask is None or mask[i]
            if live:
                has_ref[i] = st.has_reference
            p.prev_running[i] = int(st.running_options)
            p.prev_fmt[i] = self._std_prev_fmt[i]
        hdr, counts, flags = p.parse(bufs, has_ref)
        packed.counts[:] = counts
        packed.varied_mvs[:] = (flags & 2) != 0

        if BatchedStreamDecoder._STD_KIND_BY_BITS is None:
            from ..types import SourceFormatKind as K

            BatchedStreamDecoder._STD_KIND_BY_BITS = {
                1: K.SUB_QCIF, 2: K.QUARTER_CIF, 3: K.FULL_CIF,
                4: K.FOUR_CIF, 5: K.SIXTEEN_CIF}
        from ..types import SourceFormat

        rows = hdr.tobytes()
        rowlen = hdr.shape[1] * hdr.itemsize
        pic_cache, po_cache, states = self._pic_cache, self._po_cache, self.states
        for i in range(self.n):
            if mask is not None and not mask[i]:
                continue  # padded slot: no header-state commit
            key = rows[i * rowlen:(i + 1) * rowlen]
            ent = pic_cache.get(key)
            if ent is None:
                row = hdr[i]
                pic = Picture(
                    version=None,
                    temporal_reference=int(row[0]),
                    format=SourceFormat.standard(
                        BatchedStreamDecoder._STD_KIND_BY_BITS[int(row[8])]),
                    options=PictureOption(int(row[4])),
                    has_plusptype=False,
                    has_opptype=False,
                    picture_type=(PictureTypeCode.I_FRAME if row[3] == 0
                                  else PictureTypeCode.P_FRAME),
                    quantizer=int(row[5]),
                    multiplex_bitstream=(int(row[7]) if row[6] else None),
                )
                ent = (pic, int(row[9]), int(row[8]))
                pic_cache[key] = ent
            pic, running, fmt_bits = ent
            st = states[i]
            st.last_header = pic
            st.has_reference = True  # standard has no disposable frames
            po = po_cache.get(running)
            if po is None:
                po = po_cache[running] = PictureOption(running)
            st.running_options = po
            self._std_prev_fmt[i] = fmt_bits

    def parse_batch_packed(self, buffers: Sequence[bytes],
                           packed: "_PackedBatch", mask=None) -> None:
        """Parse every stream's frame in ONE native call (the whole host
        stage is a single FFI round trip).  Commits per-stream header state
        on success; a failure leaves all state untouched (the native loop
        aborts before any Python-side commit).

        `mask` (bool per slot, optional): False slots decode the cached
        skip frame instead of their buffer, with header commit and the
        reference-picture rule suppressed — used by StreamPool to pad
        empty or this-step-absent slots without shape churn."""
        if not (self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM):
            return self.parse_batch_packed_standard(buffers, packed, mask)
        from ..native import ensure_built
        from ..native.bindings import SorensonBatchParser

        if not ensure_built():
            raise RuntimeError(
                "packed transport requires the native front-end")
        if self._fused_enabled:
            return self._parse_batch_fused(buffers, packed, mask)
        if packed.batch_parser is None:
            packed.batch_parser = SorensonBatchParser(
                self.n, self.w, self.h, packed.u32, packed.mvs,
                packed.inter, self._pred_scratch, pack_val=packed.val,
                transport=packed.transport, mvs_slim=packed.mvs_slim)
        packed.fused_valid = False
        buffers, has_ref = self._prepare_sorenson_buffers(buffers, mask)
        hdr, counts, flags = packed.batch_parser.parse(buffers, has_ref)
        packed.counts[:] = counts
        packed.varied_mvs[:] = (flags & 2) != 0
        self._commit_sorenson_headers(hdr, mask)

    def _prepare_sorenson_buffers(self, buffers, mask):
        """(buffers-as-bytes, has_reference) with masked slots padded by the
        cached skip frame (header commit suppressed by the caller)."""
        if mask is None:
            has_ref = [st.has_reference for st in self.states]
            buffers = [b if type(b) is bytes else bytes(b) for b in buffers]
            return buffers, has_ref
        skip = None
        has_ref, bufs = [], []
        for i, b in enumerate(buffers):
            if mask[i]:
                has_ref.append(self.states[i].has_reference)
                bufs.append(b if type(b) is bytes else bytes(b))
            else:
                if skip is None:
                    skip = self.skip_frame_bytes()
                has_ref.append(True)  # skip frame is all-uncoded INTER
                bufs.append(skip)
        return bufs, has_ref

    def _commit_sorenson_headers(self, hdr, mask) -> None:
        # Per-stream header commit (state.rs:464-483 semantics), optimized:
        # headers repeat heavily across streams and steps, so Picture
        # construction and enum arithmetic are cached and the running-option
        # merge runs on plain ints.
        keep = int(OPPTYPE_OPTIONS | MPPTYPE_OPTIONS)
        rows = hdr.tobytes()
        rowlen = hdr.shape[1] * hdr.itemsize
        pic_cache, po_cache, states = self._pic_cache, self._po_cache, self.states
        for i in range(self.n):
            if mask is not None and not mask[i]:
                continue  # padded slot: no header-state commit
            key = rows[i * rowlen:(i + 1) * rowlen]
            ent = pic_cache.get(key)
            if ent is None:
                pic = _picture_from_fields(hdr[i])
                ent = (pic, int(pic.options) & ~keep,
                       pic.picture_type is PictureTypeCode.I_FRAME,
                       not pic.picture_type.is_disposable())
                pic_cache[key] = ent
            pic, base_opts, is_i, not_disp = ent
            st = states[i]
            running = base_opts | (int(st.running_options) & keep)
            st.last_header = pic
            if is_i or not_disp:
                st.has_reference = not_disp
            po = po_cache.get(running)
            if po is None:
                po = po_cache[running] = PictureOption(running)
            st.running_options = po

    def _parse_batch_fused(self, buffers: Sequence[bytes],
                           packed: "_PackedBatch", mask=None) -> None:
        """Fused-transport batch parse: ONE native call writes every
        stream's [int8 MVs | INTER bitmask | d24 bytes] staging row, picks
        the coefficient bucket, and pads tails to it (entropy.cpp
        h263_sorenson_decode_batch_fused)."""
        from ..native.bindings import SorensonFusedBatchParser

        stride = 8 if self._mv_full else 2
        if packed.fused is None or packed.fused_mv_stride != stride:
            nmb = self.mb_w * self.mb_h
            row = nmb * stride + (nmb + 7) // 8 + 3 * self.pack_cap
            packed.fused = np.zeros((self.n, row), dtype=np.uint8)
            packed.fused_mv_stride = stride
            packed.fused_parser = SorensonFusedBatchParser(
                self.n, self.w, self.h, packed.fused, stride,
                packed.mvs, packed.inter, self._pred_scratch, self.pack_cap,
                self._ladder)
        packed.fused_valid = False
        buffers, has_ref = self._prepare_sorenson_buffers(buffers, mask)
        hdr, counts, flags, cut = packed.fused_parser.parse(buffers, has_ref)
        packed.counts[:] = counts
        packed.varied_mvs[:] = (flags & 2) != 0
        packed.cut = cut
        packed.fused_valid = True
        self._commit_sorenson_headers(hdr, mask)

    # -- device stage -----------------------------------------------------------

    def _run(self, tensors):
        import jax
        import time

        _t0 = time.perf_counter()
        dev = jax.device_put(tensors)
        self.last_transfer_s = time.perf_counter() - _t0
        self.last_transfer_bytes = sum(a.nbytes for a in tensors)
        y, cb, cr = self._fn(*dev, self.ref_y, self.ref_cb, self.ref_cr)
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        return y, cb, cr

    def step(self, frames: Sequence[FrameData]):
        """Reconstruct one frame for every stream; updates reference planes.

        Returns (y, cb, cr) batched uint8 arrays [S, ...] (device-resident).
        """
        assert len(frames) == self.n
        return self._run((
            np.stack([f.coeffs_y for f in frames]),
            np.stack([f.class_y for f in frames]),
            np.stack([f.coeffs_cb for f in frames]),
            np.stack([f.class_cb for f in frames]),
            np.stack([f.coeffs_cr for f in frames]),
            np.stack([f.class_cr for f in frames]),
            np.stack([f.mvs for f in frames]),
            np.stack([f.inter for f in frames]),
        ))

    def step_batch(self, batch: _HostBatch):
        """Reconstruct from a _HostBatch filled by parse_one(..., batch=...).

        One device transfer for the whole batch; the zero-copy fast path.
        """
        tensors = batch.tensors()
        out = self._run(tensors)
        batch.in_flight = out  # buffer reuse gate, see next_host_batch
        incr("frames_decoded", self.n)
        incr("steps_dense")
        incr("transfer_bytes", sum(a.nbytes for a in tensors))
        return out

    def step_packed(self, packed: "_PackedBatch"):
        """Reconstruct from the packed transport (one small transfer).

        Shape stability: only THREE coefficient-transfer signatures exist —
        full capacity, a small bucket, and a tiny bucket (typical
        P-frames) — so the jit cache stays bounded while sparse steps ship
        up to ~7x fewer bytes.  The
        slim one-MV-per-MB transport sticks until the first frame with
        differing block MVs flips the decoder to the full transport
        permanently (one recompile, not per-step churn).
        """
        import jax

        if packed.fused_valid:
            return self._step_fused(packed)

        if packed.varied_mvs.any():
            self._mv_full = True
        mvs = packed.mvs if self._mv_full else packed.mvs_slim

        k = int(packed.counts.max()) if self.n else 0
        if k <= self.pack_cap_tiny:
            cut = self.pack_cap_tiny
        elif k <= self.pack_cap_small:
            cut = self.pack_cap_small
        else:
            cut = None
        small = cut is not None
        slice_t = StageTimer("bucket_slice").start()
        if packed.split:
            pos = (np.ascontiguousarray(packed.u32[:, :cut])
                   if small else packed.u32)
            vals = (np.ascontiguousarray(packed.val[:, :cut])
                    if small else packed.val)
            coef = (pos, vals)
        elif packed.transport == "d24":
            coef = (np.ascontiguousarray(packed.u32[:, :3 * cut])
                    if small else packed.u32,)
        else:
            coef = (np.ascontiguousarray(packed.u32[:, :cut])
                    if small else packed.u32,)

        host = (*coef, mvs, packed.inter)
        slice_t.stop()
        import time as _time

        _t0 = _time.perf_counter()
        with trace_stage("transfer"):
            dev = jax.device_put(host)
        self.last_transfer_s = _time.perf_counter() - _t0
        self.last_transfer_bytes = sum(a.nbytes for a in host)
        with trace_stage("reconstruct_dispatch"):
            y, cb, cr = self._packed_fn(*dev, self.ref_y, self.ref_cb,
                                        self.ref_cr)
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        packed.in_flight = (y, cb, cr)  # buffer reuse gate, next_packed_batch
        incr("frames_decoded", self.n)
        incr("steps")
        incr("transfer_bytes", sum(a.nbytes for a in host))
        return y, cb, cr

    def _fused_fn(self, mv_full: bool):
        fn = self._fused_fn_cache.get(mv_full)
        if fn is None:
            from ..decoder.reconstruct import (
                get_packed_d24_fused_reconstruct_fn)

            fn = get_packed_d24_fused_reconstruct_fn(
                self.h, self.w, mv_full)
            self._fused_fn_cache[mv_full] = fn
        return fn

    def _step_fused(self, packed: "_PackedBatch"):
        """Reconstruct from the fused staging rows: ONE device transfer of
        [mv8 | interbits | d24[:3*cut]] per step.

        Shape stability: the native-chosen cut is one of the ladder's <=3
        values, and the MV mode is sticky (slim until the first frame with
        varied block MVs), so at most 3 transfer signatures exist per MV
        mode.  The flip step itself (varied MVs discovered while the rows
        carry slim MVs) re-ships over the legacy three-leaf transport —
        its full int16 MVs are always maintained — and every later parse
        writes full-stride rows.
        """
        import jax

        flip = bool(packed.varied_mvs.any()) and packed.fused_mv_stride == 2
        if flip:
            self._mv_full = True  # next parses use stride-8 rows
            nmb = self.mb_w * self.mb_h
            off = nmb * 2 + (nmb + 7) // 8
            with trace_stage("bucket_slice"):
                coef = np.ascontiguousarray(
                    packed.fused[:, off:off + 3 * packed.cut])
            host = (coef, packed.mvs, packed.inter)
            import time as _time

            _t0 = _time.perf_counter()
            with trace_stage("transfer"):
                dev = jax.device_put(host)
            self.last_transfer_s = _time.perf_counter() - _t0
            self.last_transfer_bytes = sum(a.nbytes for a in host)
            with trace_stage("reconstruct_dispatch"):
                y, cb, cr = self._packed_fn(*dev, self.ref_y, self.ref_cb,
                                            self.ref_cr)
            nbytes = sum(a.nbytes for a in host)
        else:
            mv_full = packed.fused_mv_stride == 8
            nmb = self.mb_w * self.mb_h
            length = (nmb * packed.fused_mv_stride + (nmb + 7) // 8
                      + 3 * packed.cut)
            with trace_stage("bucket_slice"):
                buf = np.ascontiguousarray(packed.fused[:, :length])
            import time as _time

            _t0 = _time.perf_counter()
            with trace_stage("transfer"):
                dev = jax.device_put(buf)
            self.last_transfer_s = _time.perf_counter() - _t0
            self.last_transfer_bytes = buf.nbytes
            with trace_stage("reconstruct_dispatch"):
                y, cb, cr = self._fused_fn(mv_full)(
                    dev, self.ref_y, self.ref_cb, self.ref_cr)
            nbytes = buf.nbytes
        self.ref_y, self.ref_cb, self.ref_cr = y, cb, cr
        packed.in_flight = (y, cb, cr)  # buffer reuse gate, next_packed_batch
        incr("frames_decoded", self.n)
        incr("steps")
        if flip:
            incr("steps_fused_flip")  # shipped via the legacy three-leaf path
        else:
            incr("steps_fused")
        incr("transfer_bytes", nbytes)
        return y, cb, cr

    def submit_step(self, buffers: Sequence[bytes]):
        """Pipelined decode: parse this frame now (caller thread), then
        transfer+reconstruct on the pipeline worker while the caller parses
        the next frame.  Returns a Future of (y, cb, cr).

        WHEN TO USE: only on hosts with a spare core to own the transfer.
        Sequential decode_step is the deployment default on single-core
        hosts — there the transfer's CPU work just time-slices against the
        parse and the overlap measures a
        wash-to-loss (worker-side transfer inflated ~3x on the earlier
        single-core host; tools/prof_pipeline.py measures it).  Both stages release the GIL (the parse
        is one native call), so with >= 2 cores the device stage of frame
        t genuinely hides behind the parse of frame t+1.  Steps execute
        in submission order (single worker), preserving reference-plane
        state.

        Failure contract: a step's exception is delivered through the
        returned Future exactly once (buffer rotation waits on the future
        but swallows its error).  A parse failure raises here, synchronously,
        with no state committed; a device-stage failure means that frame's
        reference planes were never updated — the caller may re-submit the
        same frame or continue from the next I-frame.
        """
        import concurrent.futures

        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="h263-device")

        packed = self.next_packed_batch()
        with trace_stage("host_parse"):
            self.parse_batch_packed(buffers, packed)
        fut = self._executor.submit(self.step_packed, packed)
        packed.fut = fut  # reuse gate: the consuming step dispatches async
        return fut

    def decode_stream_pipelined(self, frame_iter):
        """Generator driving the two-stage pipeline over an iterator of
        frame-buffer lists; yields (y, cb, cr) per step in order."""
        pending = None
        for buffers in frame_iter:
            fut = self.submit_step(buffers)
            if pending is not None:
                yield pending.result()
            pending = fut
        if pending is not None:
            yield pending.result()

    def present_rgba(self, deblock: Optional[bool] = None):
        """RGBA [S, H, W, 4] of the last decoded frames, computed on device.

        deblock=None honours each stream's advisory USE_DEBLOCKER flag;
        True/False force it.  Strength = Table J.2 of the picture quantizer.
        """
        from ..decoder.reconstruct import get_present_fn
        from ..ops.deblock import QUANT_TO_STRENGTH

        strength = np.zeros(self.n, dtype=np.int32)
        flags = np.zeros(self.n, dtype=np.bool_)
        for i, st in enumerate(self.states):
            hdr = st.last_header
            if hdr is None:
                continue
            strength[i] = int(QUANT_TO_STRENGTH[hdr.quantizer & 31])
            if deblock is None:
                flags[i] = bool(hdr.options & PictureOption.USE_DEBLOCKER)
            else:
                flags[i] = deblock
        fn = get_present_fn(self.h, self.w)
        return fn(self.ref_y, self.ref_cb, self.ref_cr, strength, flags)

    def decode_step(self, buffers: Sequence[bytes], transport: str = "auto",
                    mask=None):
        """Parse all streams then reconstruct the batch.

        transport: "auto" uses the packed path when the native front-end is
        available, falling back to dense on PackOverflow; "dense"/"packed"
        force a path.  `mask` (bool per slot): False slots decode the
        cached skip frame with state commit suppressed (see
        parse_batch_packed).
        """
        import os

        from ..native import ensure_built
        from ..native.bindings import PackOverflow

        if transport not in ("auto", "packed", "dense"):
            raise ValueError(f"transport must be 'auto', 'packed', or "
                             f"'dense'; got {transport!r} (the coefficient "
                             f"encoding is the constructor's coef_transport)")
        use_packed = (transport == "packed" or (
            transport == "auto"
            and not os.environ.get("H263_TPU_NO_NATIVE")
            and ensure_built()))
        if use_packed:
            packed = self.next_packed_batch()
            try:
                with trace_stage("host_parse"):
                    self.parse_batch_packed(buffers, packed, mask=mask)
                return self.step_packed(packed)
            except PackOverflow:
                if transport == "packed":
                    raise
                # No state was committed (the native batch call fails
                # atomically before any commit); replay on the dense path.
                incr("pack_overflow_fallbacks")

        batch = self.next_host_batch()
        staged: list = []
        for i, b in enumerate(buffers):
            live = mask is None or mask[i]
            self.parse_one(i, b if live else self.skip_frame_bytes(),
                           batch=batch, commit=live, stage_commit=staged)
        for i, pic, running in staged:
            self._commit_header(i, pic, running)
        return self.step_batch(batch)
