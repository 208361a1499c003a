"""Core bitstream types for the batched H.263 (Sorenson Spark) decoder.

This module models the semantic content of an H.263 (01/2005) picture header
and macroblock layer as plain Python dataclasses / IntFlags.  It corresponds to
the type model of the reference implementation (h263/src/types.rs), but is
re-derived from the spec: where the reference encodes spec tables as Rust
enums + trait impls, we use flat dataclasses + integer flags so the values can
be packed straight into dense numpy/JAX tensors by the frame parser.

Reference parity notes cite h263/src/types.rs from ruffle-rs/h263-rs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Errors (cf. h263/src/error.rs:7-58)
# ---------------------------------------------------------------------------


class H263Error(Exception):
    """Base class for all decode errors."""

    def is_eof_error(self) -> bool:
        return isinstance(self, BitstreamExhausted)

    def is_macroblock_error(self) -> bool:
        # cf. error.rs:82-85 — only these two error kinds trigger GOB resync.
        return isinstance(self, (InvalidMacroblockHeader, InvalidMacroblockCodedBits))

    def is_gob_error(self) -> bool:
        return isinstance(self, InvalidGobHeader)


class InternalDecoderError(H263Error):
    pass


class MiddleOfBitstream(H263Error):
    """The bitstream doesn't start with a picture start code."""


class InvalidMacroblockHeader(H263Error):
    pass


class InvalidMacroblockCodedBits(H263Error):
    pass


class InvalidIntraDc(H263Error):
    pass


class InvalidShortCoefficient(H263Error):
    pass


class InvalidLongCoefficient(H263Error):
    pass


class InvalidMvd(H263Error):
    pass


class InvalidPType(H263Error):
    pass


class InvalidPlusPType(H263Error):
    pass


class InvalidGobHeader(H263Error):
    pass


class InvalidBitstream(H263Error):
    pass


class PictureFormatMissing(H263Error):
    pass


class PictureFormatInvalid(H263Error):
    pass


class UncodedIFrameBlocks(H263Error):
    pass


class BitstreamExhausted(H263Error):
    """Ran out of bits (the reference's UnexpectedEof; ends the picture)."""


class UnimplementedDecoding(H263Error):
    pass


# ---------------------------------------------------------------------------
# Decoder-level options (cf. h263/src/decoder/types.rs:3-18)
# ---------------------------------------------------------------------------


class DecoderOption(enum.IntFlag):
    NONE = 0
    SORENSON_SPARK_BITSTREAM = 1
    USE_SCALABILITY_MODE = 2


# ---------------------------------------------------------------------------
# Picture options (cf. types.rs:195-241)
# ---------------------------------------------------------------------------


class PictureOption(enum.IntFlag):
    NONE = 0
    USE_SPLIT_SCREEN = 1 << 0
    USE_DOCUMENT_CAMERA = 1 << 1
    RELEASE_FULL_PICTURE_FREEZE = 1 << 2
    UNRESTRICTED_MOTION_VECTORS = 1 << 3
    SYNTAX_BASED_ARITHMETIC_CODING = 1 << 4
    ADVANCED_PREDICTION = 1 << 5
    ADVANCED_INTRA_CODING = 1 << 6
    DEBLOCKING_FILTER = 1 << 7
    SLICE_STRUCTURED = 1 << 8
    REFERENCE_PICTURE_SELECTION = 1 << 9
    INDEPENDENT_SEGMENT_DECODING = 1 << 10
    ALTERNATIVE_INTER_VLC = 1 << 11
    MODIFIED_QUANTIZATION = 1 << 12
    REFERENCE_PICTURE_RESAMPLING = 1 << 13
    REDUCED_RESOLUTION_UPDATE = 1 << 14
    ROUNDING_TYPE_ONE = 1 << 15
    # Sorenson-only advisory deblocker request (types.rs:213-216).
    USE_DEBLOCKER = 1 << 16


#: Options that live in the OPPTYPE part of a PLUSPTYPE header; they carry
#: forward from picture to picture when OPPTYPE is absent (types.rs:220-233).
OPPTYPE_OPTIONS = (
    PictureOption.UNRESTRICTED_MOTION_VECTORS
    | PictureOption.SYNTAX_BASED_ARITHMETIC_CODING
    | PictureOption.ADVANCED_PREDICTION
    | PictureOption.ADVANCED_INTRA_CODING
    | PictureOption.DEBLOCKING_FILTER
    | PictureOption.SLICE_STRUCTURED
    | PictureOption.REFERENCE_PICTURE_SELECTION
    | PictureOption.INDEPENDENT_SEGMENT_DECODING
    | PictureOption.ALTERNATIVE_INTER_VLC
    | PictureOption.MODIFIED_QUANTIZATION
)

#: Options in the MPPTYPE part (types.rs:237-240).
MPPTYPE_OPTIONS = (
    PictureOption.REFERENCE_PICTURE_RESAMPLING
    | PictureOption.REDUCED_RESOLUTION_UPDATE
    | PictureOption.ROUNDING_TYPE_ONE
)


def carry_forward_options(pic, prev_running: "PictureOption") -> "PictureOption":
    """The running options a picture decodes under (state.rs:147-155): a
    full OPPTYPE refreshes everything; PLUSPTYPE without OPPTYPE carries
    the OPPTYPE class forward; a plain PTYPE carries both classes.  Every
    decoding surface must use this — gating on ``pic.options`` alone drops
    carried UMV / MODIFIED_QUANTIZATION and mis-decodes the MB layer."""
    if pic.has_plusptype and pic.has_opptype:
        return pic.options
    if pic.has_plusptype:
        return (pic.options & ~OPPTYPE_OPTIONS) | (
            prev_running & OPPTYPE_OPTIONS)
    return (pic.options & ~OPPTYPE_OPTIONS & ~MPPTYPE_OPTIONS) | (
        prev_running & (OPPTYPE_OPTIONS | MPPTYPE_OPTIONS))


# ---------------------------------------------------------------------------
# Picture type codes (cf. types.rs:251-299)
# ---------------------------------------------------------------------------


class PictureTypeCode(enum.Enum):
    I_FRAME = "I"
    P_FRAME = "P"
    PB_FRAME = "PB"
    IMPROVED_PB_FRAME = "IPB"
    B_FRAME = "B"
    EI_FRAME = "EI"
    EP_FRAME = "EP"
    RESERVED = "RES"
    # Sorenson-only (types.rs:280-288).
    DISPOSABLE_P_FRAME = "DP"

    def is_any_pbframe(self) -> bool:
        return self in (PictureTypeCode.PB_FRAME, PictureTypeCode.IMPROVED_PB_FRAME)

    def is_disposable(self) -> bool:
        return self is PictureTypeCode.DISPOSABLE_P_FRAME


# ---------------------------------------------------------------------------
# Source formats (cf. types.rs:136-181)
# ---------------------------------------------------------------------------


class PixelAspectRatio(enum.Enum):
    SQUARE = "square"
    PAR_12_11 = "12:11"
    PAR_10_11 = "10:11"
    PAR_16_11 = "16:11"
    PAR_40_33 = "40:33"
    RESERVED = "reserved"
    EXTENDED = "extended"


@dataclass(frozen=True)
class CustomPictureFormat:
    pixel_aspect_ratio: PixelAspectRatio
    width: int
    height: int
    par_width: int = 0
    par_height: int = 0


class SourceFormatKind(enum.Enum):
    SUB_QCIF = "sqcif"
    QUARTER_CIF = "qcif"
    FULL_CIF = "cif"
    FOUR_CIF = "4cif"
    SIXTEEN_CIF = "16cif"
    RESERVED = "reserved"
    EXTENDED = "extended"


_STANDARD_DIMS = {
    SourceFormatKind.SUB_QCIF: (128, 96),
    SourceFormatKind.QUARTER_CIF: (176, 144),
    SourceFormatKind.FULL_CIF: (352, 288),
    SourceFormatKind.FOUR_CIF: (704, 576),
    SourceFormatKind.SIXTEEN_CIF: (1408, 1152),
}


@dataclass(frozen=True)
class SourceFormat:
    kind: SourceFormatKind
    custom: Optional[CustomPictureFormat] = None

    def width_and_height(self) -> Optional[tuple[int, int]]:
        """cf. types.rs:168-180; returns None for RESERVED."""
        if self.kind is SourceFormatKind.RESERVED:
            return None
        if self.kind is SourceFormatKind.EXTENDED:
            assert self.custom is not None
            return (self.custom.width, self.custom.height)
        return _STANDARD_DIMS[self.kind]

    # Convenience constructors ------------------------------------------------
    @staticmethod
    def standard(kind: SourceFormatKind) -> "SourceFormat":
        return SourceFormat(kind)

    @staticmethod
    def extended(width: int, height: int,
                 par: PixelAspectRatio = PixelAspectRatio.SQUARE,
                 par_width: int = 0, par_height: int = 0) -> "SourceFormat":
        return SourceFormat(
            SourceFormatKind.EXTENDED,
            CustomPictureFormat(par, width, height, par_width, par_height),
        )


class MotionVectorRange(enum.Enum):
    EXTENDED = "extended"
    UNLIMITED = "unlimited"


@dataclass(frozen=True)
class CustomPictureClock:
    times_1001: bool
    divisor: int


@dataclass(frozen=True)
class ScalabilityLayer:
    enhancement: int
    reference: Optional[int]


class SliceSubmode(enum.IntFlag):
    """H.263 5.1.9 SSS slice configuration (types.rs:400-407).

    IntFlag (int subclass), so the raw 2-bit field value is preserved for
    tensor packing while the flag names carry the spec semantics.
    """

    NONE = 0
    RECTANGULAR_SLICES = 0b01
    ARBITRARY_ORDER = 0b10


class ReferencePictureSelectionMode(enum.IntFlag):
    """H.263 5.1.13 RPSMF backchannel-message request flags
    (types.rs:424-436)."""

    NONE = 0
    RESERVED = 0b001
    REQUEST_NEGATIVE_ACKNOWLEDGEMENT = 0b010
    REQUEST_ACKNOWLEDGEMENT = 0b100


class BPictureQuantizer(enum.IntEnum):
    """H.263 5.1.23 DBQUANT — B-picture quantizer as fourths
    (types.rs:529-542).  The enum value is the raw 2-bit code; the
    numerator is value + 5 (5/4 .. 8/4)."""

    FIVE = 0
    SIX = 1
    SEVEN = 2
    EIGHT = 3

    @property
    def numerator(self) -> int:
        return int(self) + 5


# ---------------------------------------------------------------------------
# Picture header (cf. types.rs:13-122)
# ---------------------------------------------------------------------------


@dataclass
class Picture:
    """A parsed picture header (H.263 5.1 / Sorenson equivalent)."""

    version: Optional[int] = None  # Sorenson only
    temporal_reference: int = 0
    format: Optional[SourceFormat] = None
    options: PictureOption = PictureOption.NONE
    has_plusptype: bool = False
    has_opptype: bool = False
    picture_type: PictureTypeCode = PictureTypeCode.I_FRAME
    motion_vector_range: Optional[MotionVectorRange] = None
    slice_submode: Optional[SliceSubmode] = None
    scalability_layer: Optional[ScalabilityLayer] = None
    reference_picture_selection_mode: Optional[ReferencePictureSelectionMode] = None
    prediction_reference: Optional[int] = None
    backchannel_message: Optional[object] = None
    reference_picture_resampling: Optional[object] = None
    quantizer: int = 1
    multiplex_bitstream: Optional[int] = None
    pb_reference: Optional[int] = None
    pb_quantizer: Optional[BPictureQuantizer] = None
    extra: bytes = b""


@dataclass(frozen=True)
class GroupOfBlocks:
    """cf. types.rs:550-575."""

    group_number: int
    multiplex_bitstream: Optional[int]
    frame_id: int
    quantizer: int


# ---------------------------------------------------------------------------
# Macroblock layer (cf. types.rs:579-687)
# ---------------------------------------------------------------------------


class MacroblockType(enum.IntEnum):
    INTER = 0
    INTER_Q = 1
    INTER_4V = 2
    INTRA = 3
    INTRA_Q = 4
    INTER_4V_Q = 5

    def is_inter(self) -> bool:
        return self in (MacroblockType.INTER, MacroblockType.INTER_Q,
                        MacroblockType.INTER_4V, MacroblockType.INTER_4V_Q)

    def is_intra(self) -> bool:
        return self in (MacroblockType.INTRA, MacroblockType.INTRA_Q)

    def has_fourvec(self) -> bool:
        return self in (MacroblockType.INTER_4V, MacroblockType.INTER_4V_Q)

    def has_quantizer(self) -> bool:
        return self in (MacroblockType.INTER_Q, MacroblockType.INTRA_Q,
                        MacroblockType.INTER_4V_Q)


@dataclass(frozen=True)
class CodedBlockPattern:
    codes_luma: tuple[bool, bool, bool, bool]
    codes_chroma_b: bool
    codes_chroma_r: bool


class MacroblockKind(enum.Enum):
    UNCODED = "uncoded"
    STUFFING = "stuffing"
    CODED = "coded"


@dataclass
class Macroblock:
    kind: MacroblockKind
    mb_type: Optional[MacroblockType] = None
    coded_block_pattern: Optional[CodedBlockPattern] = None
    coded_block_pattern_b: Optional[CodedBlockPattern] = None
    d_quantizer: Optional[int] = None
    motion_vector: Optional["MotionVector"] = None
    addl_motion_vectors: Optional[tuple] = None
    motion_vectors_b: Optional[tuple] = None


# ---------------------------------------------------------------------------
# Half-pel motion-vector arithmetic (cf. types.rs:691-823)
#
# A motion-vector component is an integer count of half pixels.  All the
# arithmetic below is pure-integer and replicated in vectorized form in
# ops/mvmath.py; these scalar versions are the readable authority used by the
# serial parser.
# ---------------------------------------------------------------------------

HALFPEL_STANDARD_RANGE = 32
HALFPEL_EXTENDED_RANGE = 64
HALFPEL_EXTENDED_RANGE_QUADCIF = 128
HALFPEL_EXTENDED_RANGE_SIXTEENCIF = 256
HALFPEL_EXTENDED_RANGE_BEYONDCIF = 512


def halfpel_from_float(value: float) -> int:
    """cf. types.rs:693-697 — floor(value * 2)."""
    import math

    return int(math.floor(value * 2.0))


def halfpel_lerp_parameters(hp: int) -> tuple[int, bool]:
    """Split into (integer offset, needs-interpolation) — types.rs:721-729.

    The offset is floor(hp/2); interpolation is needed when hp is odd.
    """
    if hp % 2 == 0:
        return hp // 2, False
    # Python // already floors, which matches the reference's trunc-then-fixup
    # for negative odd values (e.g. -3 -> (-2, True)).
    return hp // 2, True


def halfpel_invert(hp: int) -> int:
    """Wrap around the restricted MVD range (types.rs:736-742)."""
    if hp > 0:
        return hp - 64
    if hp < 0:
        return hp + 64
    return 0


def halfpel_is_mv_within_range(hp: int, range_hp: int) -> bool:
    """types.rs:745-747 — half-open interval [-range, range)."""
    return -range_hp <= hp < range_hp


def halfpel_average_sum_of_mvs(hp_sum: int) -> int:
    """Divide a sum of four MV components by 8, rounding to full pel.

    cf. types.rs:759-768.  `hp_sum` must be the sum of four half-pel values.
    Uses arithmetic shifts, so replicate with floor-division semantics.
    """
    whole = (hp_sum >> 4) << 1
    frac = hp_sum & 0x0F
    if frac <= 2:
        return whole
    if frac >= 14:
        return whole + 2
    return whole + 1


def median_of_3(a: int, b: int, c: int) -> int:
    """Median of three ints (types.rs:772-798)."""
    return sorted((a, b, c))[1]


@dataclass(frozen=True)
class MotionVector:
    """An (x, y) pair of half-pel components."""

    x: int = 0
    y: int = 0

    def __add__(self, other: "MotionVector") -> "MotionVector":
        return MotionVector(self.x + other.x, self.y + other.y)

    def average_sum_of_mvs(self) -> "MotionVector":
        return MotionVector(
            halfpel_average_sum_of_mvs(self.x), halfpel_average_sum_of_mvs(self.y)
        )

    def median_of(self, m: "MotionVector", r: "MotionVector") -> "MotionVector":
        return MotionVector(
            median_of_3(self.x, m.x, r.x), median_of_3(self.y, m.y, r.y)
        )

    def lerp_parameters(self):
        return halfpel_lerp_parameters(self.x), halfpel_lerp_parameters(self.y)


ZERO_MV = MotionVector(0, 0)


# ---------------------------------------------------------------------------
# Block layer (cf. types.rs:887-986)
# ---------------------------------------------------------------------------


def intradc_from_u8(value: int) -> Optional[int]:
    """Decode the INTRADC fixed-length code into a reconstruction level.

    Returns None for invalid FLC values (0 and 128), per Table 15/H.263
    (types.rs:930-936).  255 decodes to level 1024 (types.rs:955-961).
    """
    if value == 0 or value == 128:
        return None
    if value == 0xFF:
        return 1024
    return value << 3


@dataclass(frozen=True)
class TCoefficient:
    """A run-length TCOEF event (types.rs:971-986)."""

    is_short: bool
    run: int
    level: int


@dataclass
class Block:
    """One 8x8 block's entropy-decoded content (types.rs:887-893).

    `intradc` is the already-decoded reconstruction level (not the FLC byte).
    """

    intradc: Optional[int] = None
    tcoef: list[TCoefficient] = field(default_factory=list)


# Block sparsity classes (cf. types.rs:902-916).  These drive which exact
# arithmetic path the IDCT must take for bit-exact parity; see ops/idct.py.
BLOCK_CLASS_ZERO = 0
BLOCK_CLASS_DC = 1
BLOCK_CLASS_VERT = 2
BLOCK_CLASS_FULL = 3  # covers the reference's Horiz and Full paths (identical math)
