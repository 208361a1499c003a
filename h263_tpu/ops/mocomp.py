"""Half-pel motion compensation (the reference's `gather` stage).

Semantics (cpu/gather.rs):
  * source coordinates clamp to the picture edge (H.263 D.1 UMV rule)
  * half-pel positions interpolate bilinearly; 1-D lerp rounds half UP
    ((a+b+1)>>1, gather.rs:34-40), 2-D rounds once at the end
    ((a+b+c+d+2)>>2, gather.rs:103-111)
  * INTRA macroblocks produce zeros (the IDCT adds onto nothing)

The device formulation is per-pixel instead of per-block-copy: every output
pixel computes its own clamped source coordinate from its block's MV, which
turns the reference's branchy block copies into one dense gather + integer
blend — trivially parallel over (stream, y, x).
"""

from __future__ import annotations

import numpy as np

from ..types import MotionVector


# ---------------------------------------------------------------------------
# Golden numpy oracle — literal block-loop translation of gather.rs semantics.
# ---------------------------------------------------------------------------


def golden_gather_block(ref: np.ndarray, pos: tuple[int, int],
                        mv: MotionVector, out: np.ndarray) -> None:
    """Motion-compensate one 8x8 block from `ref` into `out` at `pos`
    (gather.rs:47-126).

    Deviation from the reference: destination clamping and stride use the
    *output* plane's dims.  The reference uses the reference picture's for
    both (gather.rs:58-76), which can only differ on a mid-stream
    resolution change with INTER macroblocks — where the reference would
    panic on an out-of-bounds write.  Real Sorenson streams change
    resolution only at I-frames, so corpus parity is unaffected.
    """
    h, w = ref.shape
    oh, ow = out.shape
    (dx, xi), (dy, yi) = mv.lerp_parameters()
    x0, y0 = pos
    src_x = x0 + dx
    src_y = y0 + dy
    cols = min(max(ow - x0, 0), 8)
    rows = min(max(oh - y0, 0), 8)

    def sample(x, y):
        return int(ref[min(max(y, 0), h - 1), min(max(x, 0), w - 1)])

    for j in range(rows):
        for i in range(cols):
            u, v = src_x + i, src_y + j
            if not xi and not yi:
                val = sample(u, v)
            else:
                s00 = sample(u, v)
                s10 = sample(u + 1, v)
                s01 = sample(u, v + 1)
                s11 = sample(u + 1, v + 1)
                if xi and yi:
                    val = (s00 + s10 + s01 + s11 + 2) // 4
                elif xi:
                    val = (s00 + s10 + 1) // 2
                else:
                    val = (s00 + s01 + 1) // 2
            out[y0 + j, x0 + i] = val


def golden_gather_plane(ref: np.ndarray, mvs_per_block: np.ndarray,
                        inter_per_block: np.ndarray, block_size: int = 8,
                        out_shape=None) -> np.ndarray:
    """Whole-plane motion compensation.

    mvs_per_block: int [nby, nbx, 2] half-pel (x, y) for each 8x8 block of
    this plane.  inter_per_block: bool [nby, nbx].  Non-inter blocks stay 0.
    `out_shape` may differ from ref.shape (mid-stream resolution change):
    destination positions use the new picture's dims while source sampling
    clamps to the reference's (gather.rs:58-61 semantics).
    """
    out = np.zeros(out_shape or ref.shape, dtype=ref.dtype)
    nby, nbx = inter_per_block.shape
    for by in range(nby):
        for bx in range(nbx):
            if not inter_per_block[by, bx]:
                continue
            mv = MotionVector(int(mvs_per_block[by, bx, 0]),
                              int(mvs_per_block[by, bx, 1]))
            golden_gather_block(ref, (bx * block_size, by * block_size), mv, out)
    return out


# ---------------------------------------------------------------------------
# JAX implementation — dense per-pixel gather.
# ---------------------------------------------------------------------------


def gather_plane_jnp(ref, mvs_per_block, inter_per_block, out_shape=None):
    """Bit-exact jnp version of golden_gather_plane for an [H, W] u8 plane.

    ref: uint8 [H, W]; mvs_per_block: int [nby, nbx, 2]; inter: bool [nby, nbx].
    Returns int32 [out_H, out_W] predictions (0 where not inter).
    `out_shape` defaults to ref.shape; pass the new picture's dims on a
    mid-stream resolution change (source clamping always uses ref's dims).
    """
    import jax.numpy as jnp

    h, w = ref.shape
    oh, ow = out_shape or (h, w)
    # The block grid must cover the output: JAX's clamped gather would
    # otherwise silently replicate the edge block's MV/inter into the
    # uncovered region, where the numpy golden leaves zeros.
    nby, nbx = inter_per_block.shape[-2], inter_per_block.shape[-1]
    assert oh <= nby * 8 and ow <= nbx * 8, (
        f"output {oh}x{ow} exceeds the {nby}x{nbx} block grid")
    mv = mvs_per_block.astype(jnp.int32)
    # floor(mv/2) and oddness (types.rs:721-729).
    delta = mv >> 1
    interp = (mv & 1) != 0

    # Per-pixel block coordinates.
    yy = jnp.arange(oh, dtype=jnp.int32)[:, None]
    xx = jnp.arange(ow, dtype=jnp.int32)[None, :]
    by = yy >> 3
    bx = xx >> 3

    dx = delta[..., 0][by, bx]
    dy = delta[..., 1][by, bx]
    xi = interp[..., 0][by, bx]
    yi = interp[..., 1][by, bx]

    sx = xx + dx
    sy = yy + dy

    refi = ref.astype(jnp.int32)

    def samp(x, y):
        x = jnp.clip(x, 0, w - 1)
        y = jnp.clip(y, 0, h - 1)
        return refi[y, x]

    s00 = samp(sx, sy)
    s10 = samp(sx + 1, sy)
    s01 = samp(sx, sy + 1)
    s11 = samp(sx + 1, sy + 1)

    both = (s00 + s10 + s01 + s11 + 2) >> 2
    xonly = (s00 + s10 + 1) >> 1
    yonly = (s00 + s01 + 1) >> 1

    val = jnp.where(xi & yi, both,
          jnp.where(xi, xonly,
          jnp.where(yi, yonly, s00)))

    mask = inter_per_block[by, bx]
    return jnp.where(mask, val, 0)


def chroma_mv_jnp(luma_mvs):
    """Derive the chroma MV from the 4 luma block MVs of each macroblock.

    luma_mvs: int [..., 4, 2] half-pel.  Sum the four vectors and divide by
    8 with H.263 rounding to full-pel units (types.rs:759-768).
    """
    import jax.numpy as jnp

    s = jnp.sum(luma_mvs.astype(jnp.int32), axis=-2)
    whole = (s >> 4) << 1
    frac = s & 0x0F
    adj = jnp.where(frac <= 2, 0, jnp.where(frac >= 14, 2, 1))
    return whole + adj
