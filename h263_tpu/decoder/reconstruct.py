"""The per-frame device reconstruction program.

This is the batch phase of decoding (SURVEY.md §3.3): given the dense
tensors produced by the host entropy front-end plus the HBM-resident
reference planes, reconstruct all three planes of the frame in one jitted
XLA program:

    out = clamp(gather_halfpel(ref, mv) + clipped_idct(levels), 0, 255)

per plane, with the chroma MV derived on device.  Everything is batched over
all macroblocks (and, in the batched variant, over concurrent streams — the
framework's primary parallel axis).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops.idct import idct_residual_jnp
from ..ops.mocomp import chroma_mv_jnp, gather_plane_jnp


# Kernel choices that named the removed hand-written Mosaic kernels.
LEGACY_PALLAS = ("tpu", "interpret")


def check_pallas(pallas) -> None:
    """Validate a decoder's `pallas` kernel choice.

    Every backend decodes through the plain XLA program below; the only
    accepted values are "auto" and "off".  LEGACY_PALLAS values named
    Mosaic kernels that no longer exist and raise with that reason."""
    if pallas in ("auto", "off"):
        return
    if pallas in LEGACY_PALLAS:
        raise ValueError(
            f"pallas={pallas!r} named the Mosaic kernels, which were "
            f"removed; every backend runs the plain XLA reconstruction "
            f"(pass 'auto' or 'off')")
    raise ValueError(f"pallas must be 'auto' or 'off'; got {pallas!r}")


def _blocks_to_plane(res, h, w):
    """[..., nby, nbx, 8, 8] -> [..., nby*8, nbx*8] cropped to [h, w]."""
    import jax.numpy as jnp

    nby, nbx = res.shape[-4], res.shape[-3]
    lead = res.shape[:-4]
    plane = jnp.swapaxes(res, -3, -2).reshape(*lead, nby * 8, nbx * 8)
    return plane[..., :h, :w]


def _expand_luma_mvs(mvs):
    """[..., mbh, mbw, 4, 2] -> per-8x8-block [..., 2*mbh, 2*mbw, 2].

    Block k order within a macroblock: 0 top-left, 1 top-right,
    2 bottom-left, 3 bottom-right (gather.rs:153-180).
    """
    import jax.numpy as jnp

    lead = mvs.shape[:-4]
    mbh, mbw = mvs.shape[-4], mvs.shape[-3]
    # [..., mbh, mbw, 2, 2, 2] with block row/col split out.
    g = mvs.reshape(*lead, mbh, mbw, 2, 2, 2)
    g = jnp.moveaxis(g, -3, -4)  # [..., mbh, 2(row), mbw, 2(col), 2]
    return g.reshape(*lead, mbh * 2, mbw * 2, 2)


def _expand_luma_mask(inter):
    import jax.numpy as jnp

    lead = inter.shape[:-2]
    mbh, mbw = inter.shape[-2], inter.shape[-1]
    m = jnp.broadcast_to(inter[..., :, None, :, None], (*lead, mbh, 2, mbw, 2))
    return m.reshape(*lead, mbh * 2, mbw * 2)


def reconstruct_frame_single(coeffs_y, class_y, coeffs_cb, class_cb,
                             coeffs_cr, class_cr, mvs, inter,
                             ref_y, ref_cb, ref_cr, out_hw=None):
    """Reconstruct one frame's Y/Cb/Cr planes (uint8).

    Shapes: coeffs_y [2mbh, 2mbw, 8, 8]; coeffs_cb/cr [mbh, mbw, 8, 8];
    mvs int16 [mbh, mbw, 4, 2]; inter bool [mbh, mbw];
    ref_y uint8 [h, w]; ref_cb/cr uint8 [ch, cw].  Plane sizes are static.
    `out_hw` (static) gives the output luma dims when they differ from the
    reference's (mid-stream resolution change).
    """
    import jax.numpy as jnp

    h, w = out_hw or ref_y.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    inter = jnp.asarray(inter).astype(jnp.bool_)

    luma_mvs = _expand_luma_mvs(mvs)
    luma_mask = _expand_luma_mask(inter)
    pred_y = gather_plane_jnp(ref_y, luma_mvs, luma_mask, out_shape=(h, w))

    cmv = chroma_mv_jnp(mvs)
    pred_cb = gather_plane_jnp(ref_cb, cmv, inter, out_shape=(ch, cw))
    pred_cr = gather_plane_jnp(ref_cr, cmv, inter, out_shape=(ch, cw))

    res_y = _blocks_to_plane(idct_residual_jnp(coeffs_y, class_y), h, w)
    res_cb = _blocks_to_plane(idct_residual_jnp(coeffs_cb, class_cb), ch, cw)
    res_cr = _blocks_to_plane(idct_residual_jnp(coeffs_cr, class_cr), ch, cw)

    clamp = lambda p, r: jnp.clip(p + r, 0, 255).astype(jnp.uint8)
    return clamp(pred_y, res_y), clamp(pred_cb, res_cb), clamp(pred_cr, res_cr)


@functools.lru_cache(maxsize=64)
def get_reconstruct_fn(h: int, w: int):
    """A jitted single-stream reconstruction program for an h x w picture.

    The output dims are bound statically so the reference planes may carry
    different (previous-resolution) dims.
    """
    import jax

    return jax.jit(functools.partial(reconstruct_frame_single, out_hw=(h, w)))


def reconstruct_frame_batched(coeffs_y, class_y, coeffs_cb, class_cb,
                              coeffs_cr, class_cr, mvs, inter,
                              ref_y, ref_cb, ref_cr):
    """Batched variant: every input carries a leading stream axis [S, ...].

    This is the framework's throughput path: N concurrent streams of the
    same resolution bucket decode as a single XLA program (SURVEY.md §2.4).
    """
    import jax

    return jax.vmap(reconstruct_frame_single)(
        coeffs_y, class_y, coeffs_cb, class_cb, coeffs_cr, class_cr,
        mvs, inter, ref_y, ref_cb, ref_cr)


@functools.lru_cache(maxsize=16)
def get_batched_reconstruct_fn(h: int, w: int):
    import jax

    return jax.jit(reconstruct_frame_batched)


def present_rgba_batched(y, cb, cr, strength, apply_deblock):
    """Device-side presentation: optional deblock + BT.601 YUV->RGBA.

    y uint8 [S, H, W]; cb/cr uint8 [S, ch, cw]; strength int32 [S] (from
    Table J.2 via the picture quantizer); apply_deblock bool [S] (the
    stream's advisory USE_DEBLOCKER flag, or a caller override).
    Returns RGBA uint8 [S, H, W, 4].  Mirrors the host composition path
    (SURVEY.md §3.4): deblock each plane, then convert.
    """
    import jax.numpy as jnp

    from ..ops.deblock import deblock_jnp
    from ..ops.yuv import yuv420_to_rgba_jnp

    s3 = strength.astype(jnp.int32)[:, None, None]
    use = apply_deblock[:, None, None] & (s3 > 0)

    def maybe_deblock(plane):
        filtered = deblock_jnp(plane, s3)
        return jnp.where(use, filtered, plane)

    return yuv420_to_rgba_jnp(maybe_deblock(y), maybe_deblock(cb),
                              maybe_deblock(cr))


@functools.lru_cache(maxsize=16)
def get_present_fn(h: int, w: int):
    import jax

    return jax.jit(present_rgba_batched)


def reconstruct_frame_packed_u32(pack_u32, mvs, inter,
                                 ref_y, ref_cb, ref_cr):
    """Batched reconstruction from the combined-u32 packed transport.

    pack_u32 int32 [S, K]: each entry is (position << 12) | (value & 0xFFF)
    with 20-bit global position and 12-bit signed dequantized value; padding
    entries carry an out-of-range position and are dropped.  `mvs` is either
    int16 [S, mbh, mbw, 4, 2] (full) or [S, mbh, mbw, 2] (slim: all four
    block MVs of each macroblock are identical — detected by the native
    front-end).
    """
    import jax.numpy as jnp

    w32 = pack_u32.astype(jnp.uint32)
    pos = (w32 >> 12).astype(jnp.int32)
    v = (w32 & 0xFFF).astype(jnp.int32)
    val = (v - ((v & 0x800) << 1)).astype(jnp.int16)  # sign-extend 12 bits
    return _reconstruct_from_posval(pos, val, mvs, inter,
                                    ref_y, ref_cb, ref_cr)


def reconstruct_frame_packed_split(pack_pos, pack_val, mvs, inter,
                                   ref_y, ref_cb, ref_cr):
    """Batched reconstruction from the split packed transport: int32
    positions + int16 values (6 B/coefficient).  Used for pictures too
    large for the combined transport's 20-bit positions (> ~2730
    macroblocks, e.g. 1280x720); padding entries carry the out-of-range
    sentinel and are dropped by the scatter."""
    return _reconstruct_from_posval(pack_pos, pack_val, mvs, inter,
                                    ref_y, ref_cb, ref_cr)


def reconstruct_frame_packed_d24(pack_u8, mvs, inter,
                                 ref_y, ref_cb, ref_cr):
    """Batched reconstruction from the delta24 transport (3 B/coefficient,
    any picture size).

    pack_u8 uint8 [S, 3K]: big-endian 24-bit entries (delta << 12) |
    (value & 0xFFF).  `delta` advances an ordinal cursor over
    (macroblock, block, zigzag) emission space (cursor starts at -1);
    value == 0 entries are advance-only escapes / padding — real
    dequantized coefficients are never zero — so the scatter runs in
    add-mode and they are no-ops.  The ordinal->rowmajor mapping is pure
    vector math plus one 64-entry dezigzag gather.  Native emitter:
    entropy.cpp F_PACK_DELTA24.
    """
    s, mbh, mbw = inter.shape
    pos, val = d24_to_posval(pack_u8, mbh, mbw)
    return _reconstruct_from_posval(pos, val, mvs, inter,
                                    ref_y, ref_cb, ref_cr,
                                    scatter_add=True)


def d24_to_posval(pack_u8, mbh, mbw):
    """Decode delta24 transport entries to (scatter position, value).

    pack_u8 uint8 [S, 3K] -> pos int32 [S, K] into the flattened
    [6*nmb, 64] coefficient space (luma 8x8-block grid row-major, then Cb,
    then Cr blocks; rowmajor within each block), val int16 [S, K].
    Padding / advance-only escapes carry value 0 (no-op under scatter-add);
    entries before the first real coefficient (ordinal cursor still -1)
    scatter to the out-of-range sentinel 6*nmb*64 and drop.  This is the
    device-side half of the transport; the emitter is entropy.cpp
    F_PACK_DELTA24 (fuzzed end-to-end by testing/fuzz.py flavor "d24").
    """
    import jax.numpy as jnp

    from ..vlc_tables import ZIGZAG_TO_ROWMAJOR

    s = pack_u8.shape[0]
    nmb = mbh * mbw
    e = pack_u8.reshape(s, -1, 3).astype(jnp.uint32)
    w = (e[..., 0] << 16) | (e[..., 1] << 8) | e[..., 2]
    delta = (w >> 12).astype(jnp.int32)
    v = (w & 0xFFF).astype(jnp.int32)
    val = (v - ((v & 0x800) << 1)).astype(jnp.int16)
    ordpos = jnp.cumsum(delta, axis=1) - 1

    mb = ordpos // 384           # 6 blocks * 64 coefficients per MB
    rem = ordpos - mb * 384
    b = rem >> 6                 # block within MB (0-3 luma, 4 Cb, 5 Cr)
    zz = rem & 63
    rm = jnp.asarray(ZIGZAG_TO_ROWMAJOR, dtype=jnp.int32)[zz]
    r_ = mb // mbw
    c_ = mb - r_ * mbw
    luma_blk = (2 * r_ + (b >> 1)) * (2 * mbw) + 2 * c_ + (b & 1)
    chroma_blk = 4 * nmb + (b - 4) * nmb + r_ * mbw + c_
    blk = jnp.where(b < 4, luma_blk, chroma_blk)
    pos = jnp.where(ordpos >= 0, blk * 64 + rm, 6 * nmb * 64)
    return pos, val


def reconstruct_frame_packed_d24_fused(buf, ref_y, ref_cb, ref_cr,
                                       mv_full=False, mbh=None, mbw=None):
    """Batched reconstruction from the fused single-leaf transport.

    buf uint8 [S, mv_sz + ib_sz + 3*K] is the one host->device array of a
    step, laid out per stream row as

        [0, mv_sz)            int8 MVs: 2 B/MB (first-block MV, slim) or
                              8 B/MB (all four block MVs) when mv_full
        [mv_sz, mv_sz+ib_sz)  INTER flags, 1 bit/MB, MSB-first per byte
        [mv_sz+ib_sz, ...)    delta24 coefficient entries (see
                              reconstruct_frame_packed_d24)

    The sections unpack on device (bitcast to int8, bit-unpack the INTER
    mask) — a few cheap elementwise ops for ~30% fewer transfer bytes and
    two fewer host->device copies per step than the three-leaf d24
    transport.
    Native producer: entropy.cpp h263_sorenson_decode_batch_fused.
    """
    import jax
    import jax.numpy as jnp

    s = buf.shape[0]
    nmb = mbh * mbw
    mv_sz = (8 if mv_full else 2) * nmb
    ib_sz = (nmb + 7) // 8

    mv8 = jax.lax.bitcast_convert_type(buf[:, :mv_sz], jnp.int8)
    mvs = mv8.astype(jnp.int16)
    if mv_full:
        mvs = mvs.reshape(s, mbh, mbw, 4, 2)
    else:
        mvs = mvs.reshape(s, mbh, mbw, 2)

    bits = buf[:, mv_sz:mv_sz + ib_sz]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    expanded = (bits[:, :, None] >> shifts[None, None, :]) & 1
    inter = expanded.reshape(s, ib_sz * 8)[:, :nmb].reshape(s, mbh, mbw)

    return reconstruct_frame_packed_d24(buf[:, mv_sz + ib_sz:], mvs, inter,
                                        ref_y, ref_cb, ref_cr)


@functools.lru_cache(maxsize=16)
def get_packed_d24_fused_reconstruct_fn(h: int, w: int, mv_full: bool):
    import jax

    mbh, mbw = -(-h // 16), -(-w // 16)
    return jax.jit(functools.partial(reconstruct_frame_packed_d24_fused,
                                     mv_full=mv_full, mbh=mbh, mbw=mbw))


def _reconstruct_from_posval(pos, val, mvs, inter,
                             ref_y, ref_cb, ref_cr, scatter_add=False):
    import jax
    import jax.numpy as jnp

    s, mbh, mbw = inter.shape
    nblk = 6 * mbh * mbw

    dense = jnp.zeros((s, nblk * 64), jnp.int16)
    if scatter_add:
        # delta24: escape/padding entries carry value 0 (real coefficients
        # are never 0) and positions never collide with real ones.
        dense = jax.vmap(lambda d, p, vv: d.at[p].add(vv, mode="drop"))(
            dense, pos, val)
    else:
        dense = jax.vmap(lambda d, p, vv: d.at[p].set(vv, mode="drop"))(
            dense, pos, val)
    return reconstruct_from_dense(dense.reshape(s, nblk, 64), mvs, inter,
                                  ref_y, ref_cb, ref_cr)


def reconstruct_from_dense(dense, mvs, inter, ref_y, ref_cb, ref_cr):
    """Batched reconstruction from an already-dense coefficient tensor
    (int16 [S, 6*nmb, 64] in the packed-transport block layout: luma grid
    row-major, then Cb, then Cr; row-major within each block).  Shared tail
    of every transport and of the device entropy front-end."""
    import jax
    import jax.numpy as jnp

    from ..ops.idct import derive_classes_jnp

    s, mbh, mbw = inter.shape
    nmb = mbh * mbw

    if mvs.ndim == 4:  # slim [S, mbh, mbw, 2] -> broadcast to 4 blocks
        mvs = jnp.broadcast_to(mvs[:, :, :, None, :], (s, mbh, mbw, 4, 2))

    classes = derive_classes_jnp(dense)

    cy = dense[:, : 4 * nmb].reshape(s, 2 * mbh, 2 * mbw, 8, 8)
    ky = classes[:, : 4 * nmb].reshape(s, 2 * mbh, 2 * mbw)
    ccb = dense[:, 4 * nmb : 5 * nmb].reshape(s, mbh, mbw, 8, 8)
    kcb = classes[:, 4 * nmb : 5 * nmb].reshape(s, mbh, mbw)
    ccr = dense[:, 5 * nmb :].reshape(s, mbh, mbw, 8, 8)
    kcr = classes[:, 5 * nmb :].reshape(s, mbh, mbw)

    return jax.vmap(reconstruct_frame_single)(
        cy, ky, ccb, kcb, ccr, kcr, mvs, inter, ref_y, ref_cb, ref_cr)


@functools.lru_cache(maxsize=16)
def get_packed_u32_reconstruct_fn(h: int, w: int):
    import jax

    return jax.jit(reconstruct_frame_packed_u32)


@functools.lru_cache(maxsize=16)
def get_packed_split_reconstruct_fn(h: int, w: int):
    import jax

    return jax.jit(reconstruct_frame_packed_split)


@functools.lru_cache(maxsize=16)
def get_packed_d24_reconstruct_fn(h: int, w: int):
    import jax

    return jax.jit(reconstruct_frame_packed_d24)
