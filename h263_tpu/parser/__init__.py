"""Host-side serial entropy front-end.

Parsing is inherently bit-serial (every VLC's position depends on all prior
symbols), so it runs on the host; the output is dense per-frame tensors that
feed the batched device reconstruction kernels (see SURVEY.md §1/§3 seam).
"""

from .picture import decode_picture, decode_gob
from .macroblock import decode_macroblock
from .block import decode_block
from .frame import FrameData, parse_frame

__all__ = [
    "decode_picture",
    "decode_gob",
    "decode_macroblock",
    "decode_block",
    "FrameData",
    "parse_frame",
]
