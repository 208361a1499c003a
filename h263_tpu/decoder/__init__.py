"""Decoder orchestration: per-stream state machine + device reconstruction."""

from .picture import DecodedPicture
from .state import H263Decoder

__all__ = ["DecodedPicture", "H263Decoder"]
