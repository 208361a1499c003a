"""BT.601 YUV 4:2:0 → RGBA conversion.

Parity with the reference `yuv` crate (yuv/src/bt601.rs): studio-swing
(16-235 / 16-240) to full-range via 16.16 fixed-point integer math, chroma
replicated (nearest) rather than interpolated — "it's what Flash Player
does" (bt601.rs:96-98).  Alpha is fixed 255.

All arithmetic is exact int32, so any evaluation order is bit-exact; the device
version is one fused elementwise program.
"""

from __future__ import annotations

import numpy as np

# 16.16 fixed-point coefficients (bt601.rs:25-29).
_GRAY = 76309    # (255/219) * 65536
_CR2R = 104597   # (255/224) * 1.402 * 65536
_CR2G = -53279   # -(255/224) * 1.402 * (0.299/0.587) * 65536
_CB2G = -25675   # -(255/224) * 1.772 * (0.114/0.587) * 65536
_CB2B = 132201   # (255/224) * 1.772 * 65536
_HALF = 32768


def golden_yuv420_to_rgba(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """y: u8 [H, W]; cb/cr: u8 [ceil(H/2), ceil(W/2)].  Returns u8 [H, W, 4]."""
    h, w = y.shape
    if h == 0 or w == 0:
        return np.zeros((h, w, 4), dtype=np.uint8)
    yy = y.astype(np.int32) - 16
    cbx = cb.astype(np.int32)[
        (np.arange(h) // 2)[:, None], (np.arange(w) // 2)[None, :]] - 128
    crx = cr.astype(np.int32)[
        (np.arange(h) // 2)[:, None], (np.arange(w) // 2)[None, :]] - 128

    gray = yy * _GRAY
    r = (gray + crx * _CR2R + _HALF) >> 16
    g = (gray + crx * _CR2G + cbx * _CB2G + _HALF) >> 16
    b = (gray + cbx * _CB2B + _HALF) >> 16

    out = np.empty((h, w, 4), dtype=np.uint8)
    out[..., 0] = np.clip(r, 0, 255)
    out[..., 1] = np.clip(g, 0, 255)
    out[..., 2] = np.clip(b, 0, 255)
    out[..., 3] = 255
    return out


def yuv420_to_rgba_jnp(y, cb, cr):
    """Bit-exact jnp version; y u8 [..., H, W], cb/cr u8 [..., H2, W2]."""
    import jax.numpy as jnp

    h, w = y.shape[-2], y.shape[-1]
    yy = y.astype(jnp.int32) - 16
    iy = (jnp.arange(h) // 2)[:, None]
    ix = (jnp.arange(w) // 2)[None, :]
    cbx = cb.astype(jnp.int32)[..., iy, ix] - 128
    crx = cr.astype(jnp.int32)[..., iy, ix] - 128

    gray = yy * _GRAY
    r = (gray + crx * _CR2R + _HALF) >> 16
    g = (gray + crx * _CR2G + cbx * _CB2G + _HALF) >> 16
    b = (gray + cbx * _CB2B + _HALF) >> 16

    clip = lambda v: jnp.clip(v, 0, 255).astype(jnp.uint8)
    a = jnp.full(r.shape, 255, dtype=jnp.uint8)
    return jnp.stack([clip(r), clip(g), clip(b), a], axis=-1)
