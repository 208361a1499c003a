"""Per-stream decoder state machine.

Parity with H263State (h263/src/decoder/state.rs): option carry-forward,
format inheritance, reference-picture management (I-frames clear the
backward reference; disposable frames never become references), and
whole-picture atomicity — a failed decode leaves reader and state untouched
(state.rs:119-137).

Two reconstruction backends:
  * "jax"   — the device path: dense tensors go to the jitted XLA program;
              reference planes stay device-resident across frames.
  * "numpy" — the golden scalar-faithful oracle (ops.golden_*), used for
              parity testing and host-only operation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..bitio import BitReader
from ..ops.deblock import QUANT_TO_STRENGTH, golden_deblock
from ..ops.idct import golden_idct_channel
from ..ops.mocomp import golden_gather_plane
from ..ops.yuv import golden_yuv420_to_rgba
from ..parser.frame import FrameData, parse_frame_auto
from ..parser.picture import decode_picture
from ..types import (
    DecoderOption,
    carry_forward_options,
    MiddleOfBitstream,
    Picture,
    PictureFormatInvalid,
    PictureFormatMissing,
    PictureOption,
    PictureTypeCode,
    UncodedIFrameBlocks,
)
from .picture import DecodedPicture
from .reconstruct import get_reconstruct_fn


def reconstruct_frame_numpy(frame: FrameData, ry: np.ndarray,
                            rcb: np.ndarray, rcr: np.ndarray):
    """Scalar-faithful single-frame reconstruction (the golden oracle):
    FrameData + reference planes -> (y, cb, cr) uint8 numpy planes.

    Shared by H263Decoder's numpy backend and host-side repair paths (the
    device front-end's tape-overflow fallback)."""
    h, w = frame.height, frame.width
    ch, cw = frame.chroma_height, frame.chroma_width

    # Per-8x8-block luma MVs and mask.
    luma_mvs = np.zeros((2 * frame.mb_h, 2 * frame.mb_w, 2), dtype=np.int32)
    for k in range(4):
        luma_mvs[(k >> 1)::2, (k & 1)::2] = frame.mvs[:, :, k, :]
    luma_mask = np.repeat(np.repeat(frame.inter, 2, axis=0), 2, axis=1)

    # Chroma MV (types.rs:759-768).
    s = frame.mvs.astype(np.int32).sum(axis=2)
    whole = (s >> 4) << 1
    fracs = s & 0x0F
    cmv = whole + np.where(fracs <= 2, 0, np.where(fracs >= 14, 2, 1))

    pred_y = golden_gather_plane(ry, luma_mvs, luma_mask, out_shape=(h, w))
    pred_cb = golden_gather_plane(rcb, cmv, frame.inter, out_shape=(ch, cw))
    pred_cr = golden_gather_plane(rcr, cmv, frame.inter, out_shape=(ch, cw))

    y = golden_idct_channel(frame.coeffs_y, frame.class_y, pred_y)
    cb = golden_idct_channel(frame.coeffs_cb, frame.class_cb, pred_cb)
    cr = golden_idct_channel(frame.coeffs_cr, frame.class_cr, pred_cr)
    return y, cb, cr


class H263Decoder:
    """Stateful decoder for a single H.263 / Sorenson Spark stream."""

    def __init__(self, decoder_options: DecoderOption = DecoderOption.NONE,
                 backend: str = "jax"):
        assert backend in ("jax", "numpy")
        self.decoder_options = decoder_options
        self.backend = backend
        self.last_picture: Optional[int] = None       # temporal reference
        self.reference_picture: Optional[int] = None  # temporal reference
        self.running_options = PictureOption.NONE
        self.reference_states: dict[int, DecodedPicture] = {}

    # -- queries (state.rs:52-78) ------------------------------------------

    def is_sorenson(self) -> bool:
        return bool(self.decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM)

    def get_last_picture(self) -> Optional[DecodedPicture]:
        if self.last_picture is None:
            return None
        return self.reference_states.get(self.last_picture)

    def get_reference_picture(self) -> Optional[DecodedPicture]:
        # Parity quirk (state.rs:72-78): when a backward reference exists,
        # the picture actually returned is the *last* picture.
        if self.reference_picture is None:
            return None
        return self.reference_states.get(self.last_picture)

    def cleanup_buffers(self) -> None:
        keep = {}
        if self.last_picture is not None and self.last_picture in self.reference_states:
            keep[self.last_picture] = self.reference_states[self.last_picture]
        if self.reference_picture is not None and self.reference_picture in self.reference_states:
            keep[self.reference_picture] = self.reference_states[self.reference_picture]
        self.reference_states = keep

    def parse_picture(self, reader: BitReader,
                      previous_picture: Optional[Picture]) -> Optional[Picture]:
        return decode_picture(reader, self.decoder_options, previous_picture)

    # -- main entry (state.rs:138-489) ----------------------------------------

    def decode_next_picture(self, reader) -> DecodedPicture:
        """Decode one picture, advancing decoder state.

        `reader` may be a BitReader or bytes.  Returns the decoded picture
        (also retrievable via get_last_picture()).  On error the reader
        position and all decoder state are left untouched.
        """
        if isinstance(reader, (bytes, bytearray, memoryview)):
            reader = BitReader(bytes(reader))
        saved_pos = reader.pos
        try:
            return self._decode_next_picture_inner(reader)
        except Exception:
            reader.pos = saved_pos
            raise

    def _decode_next_picture_inner(self, reader: BitReader) -> DecodedPicture:
        last = self.get_last_picture()
        next_picture = self.parse_picture(
            reader, last.as_header() if last else None)
        if next_picture is None:
            raise MiddleOfBitstream()

        # Option carry-forward (state.rs:147-155) — the one shared rule.
        running = carry_forward_options(next_picture, self.running_options)

        # Format resolution / inheritance (state.rs:157-165).
        if next_picture.format is not None:
            fmt = next_picture.format
        elif next_picture.picture_type is PictureTypeCode.I_FRAME:
            raise PictureFormatMissing()
        elif last is not None:
            fmt = last.format
        else:
            raise PictureFormatMissing()

        wh = fmt.width_and_height()
        if wh is None:
            raise PictureFormatInvalid()
        w, h = wh
        if w <= 0 or h <= 0:
            raise PictureFormatInvalid()

        reference = self.get_reference_picture()

        frame = parse_frame_auto(reader, next_picture, self.decoder_options,
                            running, w, h)

        # INTER anywhere (incl. synthesized tail MBs) requires a reference
        # picture (gather.rs:149).
        if frame.inter.any() and reference is None:
            raise UncodedIFrameBlocks()

        if self.backend == "jax":
            decoded = self._reconstruct_jax(frame, reference, next_picture, fmt)
        else:
            decoded = self._reconstruct_numpy(frame, reference, next_picture, fmt)

        # Reference management (state.rs:464-483).
        if next_picture.picture_type is PictureTypeCode.I_FRAME:
            self.reference_picture = None
        this_tr = next_picture.temporal_reference
        self.last_picture = this_tr
        if not next_picture.picture_type.is_disposable():
            self.reference_picture = this_tr
        self.running_options = running
        self.reference_states[this_tr] = decoded
        self.cleanup_buffers()
        return decoded

    # -- backends --------------------------------------------------------------

    def _reconstruct_jax(self, frame: FrameData, reference, header, fmt):
        import jax.numpy as jnp

        h, w = frame.height, frame.width
        ch, cw = frame.chroma_height, frame.chroma_width
        if reference is not None:
            ref_y = jnp.asarray(reference.luma)
            ref_cb = jnp.asarray(reference.chroma_b)
            ref_cr = jnp.asarray(reference.chroma_r)
        else:
            ref_y = jnp.zeros((h, w), dtype=jnp.uint8)
            ref_cb = jnp.zeros((ch, cw), dtype=jnp.uint8)
            ref_cr = jnp.zeros((ch, cw), dtype=jnp.uint8)

        fn = get_reconstruct_fn(h, w)
        y, cb, cr = fn(frame.coeffs_y, frame.class_y,
                       frame.coeffs_cb, frame.class_cb,
                       frame.coeffs_cr, frame.class_cr,
                       frame.mvs, frame.inter, ref_y, ref_cb, ref_cr)
        return DecodedPicture(header, fmt, y, cb, cr)

    def _reconstruct_numpy(self, frame: FrameData, reference, header, fmt):
        h, w = frame.height, frame.width
        ch, cw = frame.chroma_height, frame.chroma_width
        if reference is not None:
            ry, rcb, rcr = (reference.as_luma(), reference.as_chroma_b(),
                            reference.as_chroma_r())
        else:
            ry = np.zeros((h, w), dtype=np.uint8)
            rcb = np.zeros((ch, cw), dtype=np.uint8)
            rcr = np.zeros((ch, cw), dtype=np.uint8)
        y, cb, cr = reconstruct_frame_numpy(frame, ry, rcb, rcr)
        return DecodedPicture(header, fmt, y, cb, cr)

    # -- presentation helpers (SURVEY.md §3.4) ---------------------------------

    def last_picture_rgba(self, deblock: Optional[bool] = None) -> Optional[np.ndarray]:
        """Convenience: last decoded picture as RGBA [h, w, 4].

        `deblock=None` honours the stream's advisory USE_DEBLOCKER flag;
        True/False force it.  Strength comes from the picture quantizer via
        Table J.2 (deblock.rs:5-8).
        """
        pic = self.get_last_picture()
        if pic is None:
            return None
        hdr = pic.as_header()
        if deblock is None:
            deblock = bool(hdr.options & PictureOption.USE_DEBLOCKER)
        strength = int(QUANT_TO_STRENGTH[hdr.quantizer & 31])

        if self.backend == "jax":
            import jax.numpy as jnp

            from .reconstruct import get_present_fn

            fn = get_present_fn(pic.height, pic.width)
            rgba = fn(jnp.asarray(pic.luma)[None],
                      jnp.asarray(pic.chroma_b)[None],
                      jnp.asarray(pic.chroma_r)[None],
                      np.array([strength], dtype=np.int32),
                      np.array([deblock], dtype=np.bool_))
            return np.asarray(rgba)[0]

        y, cb, cr = pic.as_yuv()
        if deblock and strength > 0:
            y = golden_deblock(y, strength)
            cb = golden_deblock(cb, strength)
            cr = golden_deblock(cr, strength)
        return golden_yuv420_to_rgba(y, cb, cr)
