"""8x8 inverse DCT with fused residual-add and clamp.

The H.263 IDCT here is defined *operationally*: the output must match the
reference's f32 arithmetic bit-for-bit (cpu/idct.rs), because the decoder
loop feeds reconstructed pixels back as predictions — a 1-LSB divergence
compounds over a GOP.  That pins down three things:

1. The basis constants are the reference's own f32 values (idct.rs:39-48,
   produced by its libm cosf — NOT equal to f64-derived constants in the
   last ULP).  Transcribed verbatim below as numeric data.
2. Accumulation order: each 1-D IDCT accumulates over frequency 0..7 in
   order, in f32 (idct.rs:52-65).  We reproduce it as 8 sequential
   elementwise multiply-adds rather than a matmul: any dot product
   reassociates the sum, and an f32 dot on a GPU may run in TF32.
3. Rounding: out = clamp(trunc(v/4 + signum(v)*0.5), -256, 255), then
   clamp(out + prediction, 0, 255) (idct.rs:119-131, 190-195).

Block sparsity classes change the arithmetic (not just the cost):
  ZERO — contributes nothing.
  DC   — clipped = trunc(dc*0.5/4 + sign*0.5): exact power-of-2 scaling.
  VERT — 1-D IDCT of column 0, then scale by B[0][0] *after* the sum.
  FULL — two 1-D passes (covers the reference's Horiz case bit-exactly,
         since a row-0-only input degenerates to the same multiplies).
"""

from __future__ import annotations

import numpy as np

from ..types import (
    BLOCK_CLASS_DC,
    BLOCK_CLASS_FULL,
    BLOCK_CLASS_VERT,
    BLOCK_CLASS_ZERO,
)

# The reference's precomputed f32 cosine basis (idct.rs:39-48); row 0 folds in
# the 1/sqrt(2) DC scaling.  BASIS[freq][x].
BASIS_F32 = np.array(
    [
        [0.70710677, 0.70710677, 0.70710677, 0.70710677,
         0.70710677, 0.70710677, 0.70710677, 0.70710677],
        [0.98078525, 0.8314696, 0.5555702, 0.19509023,
         -0.19509032, -0.55557036, -0.83146966, -0.9807853],
        [0.9238795, 0.38268343, -0.38268352, -0.9238796,
         -0.9238795, -0.38268313, 0.3826836, 0.92387956],
        [0.8314696, -0.19509032, -0.9807853, -0.55557,
         0.55557007, 0.98078525, 0.19509007, -0.8314698],
        [0.70710677, -0.70710677, -0.70710665, 0.707107,
         0.70710677, -0.70710725, -0.70710653, 0.7071068],
        [0.5555702, -0.9807853, 0.19509041, 0.83146936,
         -0.8314698, -0.19508928, 0.9807853, -0.55557007],
        [0.38268343, -0.9238795, 0.92387974, -0.3826839,
         -0.38268384, 0.9238793, -0.92387974, 0.3826839],
        [0.19509023, -0.55557, 0.83146936, -0.9807852,
         0.98078525, -0.83147013, 0.55557114, -0.19508967],
    ],
    dtype=np.float32,
)

B00 = BASIS_F32[0, 0]  # 0.70710677f


# ---------------------------------------------------------------------------
# Golden numpy oracle
# ---------------------------------------------------------------------------


def _idct_1d_f32(vec: np.ndarray) -> np.ndarray:
    """Sequential-order f32 1-D IDCT of an 8-vector (idct.rs:52-65).

    out[i] = sum over freq of vec[freq] * BASIS[freq][i], accumulated in
    freq order.
    """
    out = np.zeros(8, dtype=np.float32)
    for freq in range(8):
        out = (out + vec[freq] * BASIS_F32[freq]).astype(np.float32)
    return out


def _round_clip(v: np.ndarray) -> np.ndarray:
    """clamp(trunc(v/4 + signum(v)*0.5), -256, 255) in f32 → int32.

    Rust f32::signum(±0.0) = ±1.0, which is irrelevant after trunc; we use
    where(v<0,-0.5,0.5) which matches for all nonzero v.
    """
    v = v.astype(np.float32)
    biased = (v / np.float32(4.0) + np.where(v < 0, np.float32(-0.5), np.float32(0.5))).astype(np.float32)
    return np.clip(np.trunc(biased), -256, 255).astype(np.int32)


def golden_idct_block(coeffs: np.ndarray, block_class: int) -> np.ndarray:
    """The clipped IDCT residual of one block, as int32 [8,8] ([y][x])."""
    if block_class == BLOCK_CLASS_ZERO:
        return np.zeros((8, 8), dtype=np.int32)
    if block_class == BLOCK_CLASS_DC:
        dc = np.float32(coeffs[0, 0])
        v = np.float32(dc * np.float32(0.5) / np.float32(4.0))
        bias = np.float32(-0.5) if dc < 0 else np.float32(0.5)
        clipped = int(np.clip(np.trunc(np.float32(v + bias)), -256, 255))
        return np.full((8, 8), clipped, dtype=np.int32)
    if block_class == BLOCK_CLASS_VERT:
        w = _idct_1d_f32(coeffs[:, 0].astype(np.float32))
        scaled = (w * B00).astype(np.float32)
        col = _round_clip(scaled)  # indexed by y
        return np.repeat(col[:, None], 8, axis=1)
    # FULL (also covers the reference's Horiz case)
    # Stage A: 1-D IDCT of each row; stageA[y][i] = idct_1d(coeffs[y])[i].
    stage_a = np.stack([_idct_1d_f32(coeffs[y].astype(np.float32)) for y in range(8)])
    # Transpose, stage B (idct.rs:170-181): pixel(x,y) = stageB[x][y] where
    # stageB[r] = idct_1d(stage_a.T[r]).
    inter = stage_a.T.copy()
    stage_b = np.stack([_idct_1d_f32(inter[r]) for r in range(8)])
    # stage_b is indexed [x][y]; convert to [y][x].
    return _round_clip(stage_b).T


def golden_classes(dense_blocks: np.ndarray) -> np.ndarray:
    """Numpy twin of derive_classes_jnp: int8 [...] from int16 [..., 64]."""
    nz = dense_blocks.reshape(*dense_blocks.shape[:-1], 8, 8) != 0
    any_nz = nz.any(axis=(-1, -2))
    off_row0 = nz[..., 1:, :].any(axis=(-1, -2))
    off_col0 = nz[..., :, 1:].any(axis=(-1, -2))
    cls = np.where(~any_nz, BLOCK_CLASS_ZERO,
          np.where(~off_row0 & ~off_col0, BLOCK_CLASS_DC,
          np.where(~off_col0, BLOCK_CLASS_VERT, BLOCK_CLASS_FULL)))
    return cls.astype(np.int8)


def golden_idct_dense(dense_blocks: np.ndarray) -> np.ndarray:
    """golden_idct_block over every block of int16 [..., 64], vectorised.

    Every numpy f32 operation rounds to f32 on its own (numpy never
    contracts), and sums run in frequency order, so this equals the
    per-block oracle exactly.  Returns int16 [..., 64]."""
    lead = dense_blocks.shape[:-1]
    flat = dense_blocks.reshape(-1, 8, 8)
    cls = golden_classes(flat.reshape(-1, 64))
    out = np.zeros(flat.shape, dtype=np.int16)
    f32 = np.float32

    def idct_last(x):
        acc = x[..., 0:1] * BASIS_F32[0]
        for f in range(1, 8):
            acc = acc + x[..., f:f + 1] * BASIS_F32[f]
        return acc

    full = cls == BLOCK_CLASS_FULL
    if full.any():
        c = flat[full].astype(f32)
        stage_b = idct_last(np.swapaxes(idct_last(c), -1, -2))
        out[full] = _round_clip(np.swapaxes(stage_b, -1, -2))
    vert = cls == BLOCK_CLASS_VERT
    if vert.any():
        w = idct_last(flat[vert][:, :, 0].astype(f32)) * B00
        out[vert] = np.repeat(_round_clip(w)[:, :, None], 8, axis=2)
    dc = cls == BLOCK_CLASS_DC
    if dc.any():
        d = flat[dc][:, 0, 0].astype(f32)
        v = d * f32(0.5) / f32(4.0)
        bias = np.where(d < 0, f32(-0.5), f32(0.5))
        out[dc] = np.clip(np.trunc(v + bias), -256, 255).astype(
            np.int16)[:, None, None]
    return out.reshape(*lead, 64)


def golden_idct_channel(coeffs: np.ndarray, classes: np.ndarray,
                        plane: np.ndarray) -> np.ndarray:
    """Whole-plane IDCT + residual add (idct.rs:82-201).

    `plane` is the u8 prediction plane [h, w] (zeros for intra); returns the
    reconstructed u8 plane.  Blocks overhanging the plane edge are clipped.
    """
    h, w = plane.shape
    nby, nbx = classes.shape
    out = plane.astype(np.int32)
    for by in range(nby):
        ys = min(max(h - by * 8, 0), 8)
        if ys == 0:
            continue
        for bx in range(nbx):
            xs = min(max(w - bx * 8, 0), 8)
            if xs == 0 or classes[by, bx] == BLOCK_CLASS_ZERO:
                continue
            res = golden_idct_block(coeffs[by, bx], int(classes[by, bx]))
            y0, x0 = by * 8, bx * 8
            region = out[y0 : y0 + ys, x0 : x0 + xs]
            out[y0 : y0 + ys, x0 : x0 + xs] = np.clip(
                region + res[:ys, :xs], 0, 255)
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# JAX implementation (bit-exact): vectorized over all blocks of a plane.
# ---------------------------------------------------------------------------


def idct_residual_jnp(coeffs, classes):
    """Clipped IDCT residuals for all blocks: int32 [..., nby, nbx, 8, 8].

    Bit-exact to golden_idct_block for every class.  The sequential f32
    multiply-adds are elementwise ops; XLA preserves IEEE semantics (no
    reassociation), so accumulation order matches the reference.
    """
    import jax.numpy as jnp

    basis = jnp.asarray(BASIS_F32)
    c = coeffs.astype(jnp.float32)

    def idct1d_last(x):
        # x[..., 8] -> out[..., 8]; sequential accumulation over frequency.
        #
        # FMA hazard: a backend compiling with allow-excess-precision may
        # contract mul+add into an FMA, skipping the product's f32 rounding
        # and diverging from the reference by 1 ulp — enough to flip the
        # trunc() at rounding boundaries (caught by the 60-frame soak
        # test).  HLO-level barriers cannot prevent this (it happens in the
        # backend).  XLA:CPU contracts inside fusions, so the CPU tests
        # disable its fusion pass (tests/conftest.py).  XLA:GPU emits
        # mul.rn.f32 / add.rn.f32, which ptxas never merges; chip_smoke.py
        # and bench.py assert that on the card with the strict gate.
        acc = x[..., 0:1] * basis[0]
        for f in range(1, 8):
            acc = acc + x[..., f : f + 1] * basis[f]
        return acc

    def round_clip(v):
        bias = jnp.where(v < 0, jnp.float32(-0.5), jnp.float32(0.5))
        return jnp.clip(jnp.trunc(v / jnp.float32(4.0) + bias), -256, 255
                        ).astype(jnp.int32)

    # FULL: stageA over rows (axis -1 = x), then stageB over y.
    stage_a = idct1d_last(c)                        # [..., y, i]
    inter = jnp.swapaxes(stage_a, -1, -2)           # [..., i, y]
    stage_b = idct1d_last(inter)                    # [..., x, y]
    full = round_clip(jnp.swapaxes(stage_b, -1, -2))  # [..., y, x]

    # VERT: 1-D IDCT of column 0, scale by B00 after the sum.
    col = c[..., :, 0]                              # [..., y]->freq order
    wv = idct1d_last(col) * basis[0, 0]             # [..., y]
    vert = jnp.broadcast_to(round_clip(wv)[..., :, None], full.shape)

    # DC: exact power-of-two scaling.
    dc = c[..., 0:1, 0:1]
    dcv = dc * jnp.float32(0.5) / jnp.float32(4.0)
    bias = jnp.where(dc < 0, jnp.float32(-0.5), jnp.float32(0.5))
    dcr = jnp.clip(jnp.trunc(dcv + bias), -256, 255).astype(jnp.int32)
    dcfull = jnp.broadcast_to(dcr, full.shape)

    cls = classes[..., None, None].astype(jnp.int32)
    res = jnp.where(cls == BLOCK_CLASS_FULL, full,
          jnp.where(cls == BLOCK_CLASS_VERT, vert,
          jnp.where(cls == BLOCK_CLASS_DC, dcfull, 0)))
    return res


def idct_residual_dense_jnp(dense_blocks):
    """Clipped residuals of dense int16 [..., 64] blocks, as int16 [..., 64].

    The same arithmetic reconstruct_from_dense runs (classes derived from
    the nonzero pattern, then idct_residual_jnp), on the dense layout the
    golden_idct_dense oracle takes."""
    import jax.numpy as jnp

    lead = dense_blocks.shape[:-1]
    classes = derive_classes_jnp(dense_blocks)
    res = idct_residual_jnp(dense_blocks.reshape(*lead, 8, 8), classes)
    return res.reshape(*lead, 64).astype(jnp.int16)


def derive_classes_jnp(dense_blocks):
    """Derive sparsity classes from dense coefficients: int8 [..., nb].

    `dense_blocks` is int16 [..., nb, 64] (row-major within each block).
    Equivalent to the host-side classification in inverse_rle (rle.rs
    semantics): coefficients are never zero when coded, so the dense
    nonzero pattern carries the same information as the per-event flags.
    """
    import jax.numpy as jnp

    nz = dense_blocks != 0
    any_nz = nz.any(axis=-1)
    # y > 0: row-major positions 8..63
    off_row0 = nz[..., 8:].any(axis=-1)
    # x > 0: positions whose column is nonzero
    col_mask = (jnp.arange(64) % 8) != 0
    off_col0 = (nz & col_mask).any(axis=-1)
    is_horiz = ~off_row0
    is_vert = ~off_col0
    cls = jnp.where(
        ~any_nz, BLOCK_CLASS_ZERO,
        jnp.where(is_horiz & is_vert, BLOCK_CLASS_DC,
                  jnp.where(is_vert, BLOCK_CLASS_VERT, BLOCK_CLASS_FULL)))
    return cls.astype(jnp.int8)
