"""h263_tpu — a batched H.263 (Sorenson Spark) decode framework in JAX.

A ground-up rebuild of the capabilities of ruffle-rs/h263-rs for
accelerators (an NVIDIA GPU today): a host or on-device entropy front-end
emits dense per-frame tensors; dequant, IDCT, half-pel motion compensation,
deblocking, and BT.601 color conversion run as batched XLA programs over
all macroblocks of many concurrent streams.  Output is bit-exact with the
reference decoder.

Public surface mirrors the reference crates:
  * H263Decoder.decode_next_picture  — h263::H263State::decode_next_picture
  * parser.decode_picture            — h263::parser::decode_picture
  * ops.yuv / ops.deblock            — the `yuv` and `deblock` crates
"""

from .types import (
    BPictureQuantizer,
    DecoderOption,
    H263Error,
    MotionVector,
    Picture,
    PictureOption,
    PictureTypeCode,
    ReferencePictureSelectionMode,
    SliceSubmode,
    SourceFormat,
    SourceFormatKind,
)
from .bitio import BitReader
from .decoder import DecodedPicture, H263Decoder

__version__ = "0.1.0"

__all__ = [
    "BPictureQuantizer",
    "BitReader",
    "DecodedPicture",
    "DecoderOption",
    "H263Decoder",
    "H263Error",
    "MotionVector",
    "Picture",
    "PictureOption",
    "PictureTypeCode",
    "ReferencePictureSelectionMode",
    "SliceSubmode",
    "SourceFormat",
    "SourceFormatKind",
    "__version__",
]
