"""Device-side entropy front-end: batched VLC decode as a vector program.

The host front-end (parser/frame.py, native/entropy.cpp) decodes one stream
per core, serially, so on a host with few cores it dominates the step.
This module moves the
entropy decode itself onto the device: N independent streams are N parallel
lanes, each running the same serial VLC automaton in lockstep over a
`lax.while_loop`.  Per-lane control flow becomes per-lane *state* plus
masked selects — the classic SIMT formulation of a bitstream interpreter —
so one device program replaces N serial host parses.

Semantics are transcribed from the same authorities as the host parsers and
cite the reference implementation (read-only, /root/reference):

* macroblock layer: parser/macroblock.py / h263/src/parser/macroblock.rs:445-549
* block layer:      parser/block.py / h263/src/parser/block.rs:670-755
* inverse RLE:      parser/frame.py::inverse_rle / h263/src/decoder/cpu/rle.rs:82-172
* MV prediction:    parser/mvpred.py / h263/src/decoder/cpu/mvd_pred.rs:27-134
* EOF semantics:    bitio.py::read_vlc / h263/src/parser/reader.rs:272-290 and
  the decode_next_picture error arms (state.rs:386-427): EOF inside the
  macroblock *header* (COD..MVDs) ends the picture with INTER/zero-MV
  tail-fill; EOF inside the *block* layer fails the whole picture.

Scope: Sorenson Spark AND standard H.263 I/P frames, including UMV
(round 4: table-D.3 fixed-code MVDs + EXTENDED/UNLIMITED range rules run
in the automaton) and — round 4 late — GOB-bearing standard payloads:
the host's GOB-resync scan on soft MB errors runs as a lane-local peek
(picture boundary ends the picture; a real GOB header fails the frame
with UnimplementedDecoding, the reference's own deliberate stub,
gob.rs:20-42).  Round 5 closed the last host gate: MODIFIED_QUANTIZATION
pictures run in-automaton too — the first coded MB fails with the
reference's own UnimplementedDecoding (macroblock.rs:497-498, ptype bit
64), so `supports()` is unconditional and no per-frame host
option-sniffing remains.  Per-stream errors are recorded in a device-resident status
vector (never implicitly read back);
an errored lane yields the identity frame (all-INTER, zero MVs, zero
coefficients == repeat of the reference picture), matching the
whole-picture-transaction semantics of the reference: a failed decode
leaves the previous picture current (state.rs:119-137).

Outputs are *iteration tapes*, not dense tensors: every loop iteration
appends (at a static per-iteration slot — a dynamic-update-slice, not a
scatter) at most one coefficient entry and one record entry per lane.
A small post-pass (`assemble`) turns the tapes into the packed-transport
inputs the existing reconstruction program already consumes
(decoder/reconstruct.py::_reconstruct_from_posval): one scatter-add for
coefficients + one scatter for records.  The zigzag->rowmajor mapping and
the dense coefficient layout are shared with the delta24 transport.

The automaton body is written in plain int32/uint32 jnp ops (no i64, no
Python branching on traced values).  It lowers through XLA; a Pallas
kernel harness around the same body was retired in round 5 — Mosaic has
no lowering for the VLC-table gathers.
"""

from __future__ import annotations

import functools

import numpy as np

from ..vlc_tables import (
    CBPY_CODES,
    MCBPC_I_CODES,
    MCBPC_P_CODES,
    MVD_CODES,
    TCOEF_CODES,
    VLC_ESCAPE,
    VLC_INVALID,
    VLC_STUFFING,
)

# --------------------------------------------------------------------------
# Phases of the per-lane automaton
# --------------------------------------------------------------------------

PH_HEADER = 0   # COD + MCBPC + CBPY + DQUANT (one iteration per attempt)
PH_MVD = 1      # one MVD pair per iteration (1 or 4 per inter MB)
PH_DC = 2       # INTRADC byte
PH_COEF = 3     # one TCOEF event per iteration
PH_DONE = 4     # EOF at a macroblock boundary: success (tail-fill applies)
PH_ERR = 5      # bitstream error: whole frame fails (identity frame)

# Status codes (device-resident; 0 = ok).  The classes mirror the host
# error taxonomy (types.py / error.rs:7-92) coarsely: what matters for
# behavior is ok / end-of-picture / frame-failed.
ST_OK = 0
ST_EOF_IN_BLOCK = 1        # BitstreamExhausted inside block layer
ST_BAD_MCBPC = 2           # InvalidMacroblockHeader
ST_BAD_CBPY = 3            # InvalidMacroblockCodedBits
ST_BAD_MVD = 4             # InvalidMvd
ST_BAD_INTRADC = 5         # InvalidIntraDc
ST_BAD_TCOEF = 6           # InvalidShortCoefficient
ST_BAD_ESCAPE = 7          # InvalidLongCoefficient (level == 0)
ST_BEYOND_NMB = 8          # coded content past the MB count (InvalidBitstream)
ST_UNIMPLEMENTED = 9       # coded MB in a non-I/P picture (macroblock.rs:461-464)
ST_TAPE_OVERFLOW = 10      # iteration budget exhausted (transport cap; see
                           # DeviceFrontend docs — caller re-decodes on host)


def status_error_class(status: int):
    """Map a device status code to the host error class the host parser
    would have raised for the same stream (None for OK/overflow)."""
    from ..types import (
        BitstreamExhausted,
        InvalidBitstream,
        InvalidIntraDc,
        InvalidLongCoefficient,
        InvalidMacroblockCodedBits,
        InvalidMacroblockHeader,
        InvalidMvd,
        InvalidShortCoefficient,
        UnimplementedDecoding,
    )

    return {
        ST_EOF_IN_BLOCK: BitstreamExhausted,
        ST_BAD_MCBPC: InvalidMacroblockHeader,
        ST_BAD_CBPY: InvalidMacroblockCodedBits,
        ST_BAD_MVD: InvalidMvd,
        ST_BAD_INTRADC: InvalidIntraDc,
        ST_BAD_TCOEF: InvalidShortCoefficient,
        ST_BAD_ESCAPE: InvalidLongCoefficient,
        ST_BEYOND_NMB: InvalidBitstream,
        ST_UNIMPLEMENTED: UnimplementedDecoding,
    }.get(int(status))

# Macroblock types, numerically identical to types.MacroblockType.
_MT_INTER, _MT_INTER_Q, _MT_INTER_4V, _MT_INTRA, _MT_INTRA_Q, _MT_INTER_4V_Q = range(6)

# --------------------------------------------------------------------------
# Table packing: each VLC table becomes a dense 2^maxlen int32 array indexed
# by the next `maxlen` bits (zero-padded at EOF, exactly like
# bitio.BitReader.peek_bits_padded).  Entry layout:
#   bits 0..12   value field (table-specific, below)
#   bits 16..20  code length in bits
#   bit 24       STUFFING (MCBPC) / ESCAPE (TCOEF)
#   bit 25       INVALID
# --------------------------------------------------------------------------

_F_MARK = 1 << 24
_F_INVALID = 1 << 25


def _pack_table(codes, maxlen, value_fn):
    size = 1 << maxlen
    out = np.zeros(size, dtype=np.int32)
    seen = np.zeros(size, dtype=bool)
    for code, value in codes:
        n = len(code)
        entry = n << 16
        if value == VLC_INVALID:
            entry |= _F_INVALID
        elif value in (VLC_STUFFING, VLC_ESCAPE):
            entry |= _F_MARK
        else:
            entry |= value_fn(value)
        start = int(code, 2) << (maxlen - n)
        span = 1 << (maxlen - n)
        if seen[start:start + span].any():
            raise ValueError(f"overlapping code {code}")
        out[start:start + span] = entry
        seen[start:start + span] = True
    if not seen.all():
        raise ValueError("incomplete prefix code")
    return out


def _mcbpc_value(v):
    mb_type, cb, cr = v
    return int(mb_type) | (int(cb) << 3) | (int(cr) << 4)


def _cbpy_value(v):
    return sum(int(b) << k for k, b in enumerate(v))


def _mvd_value(v):
    return int(v) & 0xFF  # int8 two's complement (half-pel, -32..31)


def _tcoef_value(v):
    last, run, mag = v
    return int(mag) | (int(run) << 5) | (int(last) << 11)


MCBPC_I_LEN = 9
MCBPC_P_LEN = 13
CBPY_LEN = 6
MVD_LEN = 13
TCOEF_LEN = 13

MCBPC_I_ARR = _pack_table(MCBPC_I_CODES, MCBPC_I_LEN, _mcbpc_value)
MCBPC_P_ARR = _pack_table(MCBPC_P_CODES, MCBPC_P_LEN, _mcbpc_value)
CBPY_ARR = _pack_table(CBPY_CODES, CBPY_LEN, _cbpy_value)
MVD_ARR = _pack_table(MVD_CODES, MVD_LEN, _mvd_value)
TCOEF_ARR = _pack_table(TCOEF_CODES, TCOEF_LEN, _tcoef_value)


# --------------------------------------------------------------------------
# Record index spaces (one scatter covers all record kinds).
# A record's target index within the (S, 10*nmb) staging array:
#   [0, nmb)            per-MB record: inter flag, is4v flag, broadcast MV
#                       (for 4V MBs: block 3's MV rides here)
#   [nmb, 4*nmb)        per-block MV records for 4V blocks 0..2: nmb + mb*3 + k
#   [4*nmb, 10*nmb)     block-discard flags (zigzag overflow): 4*nmb + mb*6 + blk
# Values carry bit 22 as a presence marker so staging zero = "no record".
# --------------------------------------------------------------------------

# MB-record flag bits (rec_flg tape; the record VALUE is two int16 MV
# components — see _pack_mv_record).
_FLG_PRESENT = 1
_FLG_INTER = 1 << 1
_FLG_4V = 1 << 2


def _sign8(v):
    import jax.numpy as jnp

    return ((v & 0xFF) ^ 0x80) - 0x80


def _sign16(v):
    """Two's-complement int16 view of the low 16 bits — BOTH the MV record
    unpack and the per-commit MV wrap (the native parser stores every
    committed MV and predictor as int16_t; the automaton and the Python
    parser match that contract exactly so all three front-ends agree even
    on adversarial UMV chains that overflow 16 bits)."""
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def _pack_mv_record(x, y):
    """MV record value: two int16 components (UMV table-D.3 MVDs reach
    |4095| and wrapped sums use the full int16 range — see _sign16).
    Present/inter/4V flags travel in the separate rec_flg tape."""
    return (x & 0xFFFF) | ((y & 0xFFFF) << 16)


def _pack_mv_flags(inter, is4v):
    return _FLG_PRESENT | (inter << 1) | (is4v << 2)


# --------------------------------------------------------------------------
# Guarded 32-bit shifts (shift amounts may legally reach 32, which is UB in
# XLA's shift ops).  Amounts are dynamic int32 in [0, 32].
# --------------------------------------------------------------------------


def _shl32(x, n):
    import jax.numpy as jnp

    return jnp.where(n >= 32, jnp.uint32(0), x << jnp.minimum(n, 31).astype(jnp.uint32))


def _shr32(x, n):
    import jax.numpy as jnp

    return jnp.where(n >= 32, jnp.uint32(0), x >> jnp.minimum(n, 31).astype(jnp.uint32))


def _peek(hi, c, n):
    """Peek `n` bits starting `c` bits into the 64-bit window.

    All decode sites satisfy c + n <= 32, so only `hi` is needed; `c` and
    `n` are dynamic.  Returns uint32.
    """
    import jax.numpy as jnp

    return _shr32(_shl32(hi, c), (32 - n))


def _lookup(table, maxlen, hi, c):
    """Decode one VLC at window offset `c`: returns the packed entry (i32)
    and its length.  Zero-padded peek + dense-LUT index — bit-identical to
    bitio.read_vlc over a PrefixLut."""
    import jax.numpy as jnp

    idx = _peek(hi, c, jnp.int32(maxlen)).astype(jnp.int32)
    ent = jnp.take(table, idx, axis=0)
    return ent, (ent >> 16) & 31


# --------------------------------------------------------------------------
# The automaton
# --------------------------------------------------------------------------


def make_step(data_u32, nbits, ptype, sorenson_v1, *, mbh: int, mbw: int,
              tables=None, base=None, width=None, height=None):
    """Build the lockstep automaton for one batch: returns
    (init_state, step) where step(state) -> (new_state, emissions).

    Ragged payload mode: when `base` (int32 [S], word offsets) is given,
    data_u32 is a FLAT uint32 [Nw] word buffer holding every lane's
    word-aligned payload back to back — lane i's words live at
    base[i] .. base[i] + ceil(nbits[i]/32).  Reads past a lane's own words
    return 0, exactly as the row layout's zero padding does, so the two
    layouts are observably identical to the automaton (differentially
    pinned by tests/test_device_frontend.py).  The flat layout ships
    sum(len) bytes per step instead of S * max(len) — the transfer-byte
    lever for the device front-end.

    The step function is pure int32/uint32 jnp; parse_frames_device wraps
    it in a lax.while_loop carrying the tapes.  (A Pallas kernel harness
    around the same body was retired: Mosaic could not lower its
    VLC-table gathers.)

    Args:
      data_u32: uint32 [S, Lw] — frame payload bytes packed big-endian into
        32-bit words (zero-padded); the whole frame including the picture
        header (the init state's start_bit skips the header, which the host
        parses).
      nbits: int32 [S] — number of valid bits in each stream.
      ptype: int32 [S] — bits 0-1: 0 = I-frame, 1 = P-frame, 2 = other (a
        coded MB in an "other" picture raises UnimplementedDecoding,
        matching macroblock.rs:461-464; uncoded COD=1 MBs still parse).
        Bit 2 (value +4) marks a STANDARD (non-Sorenson) picture: its
        MB layer is identical except that invalid MCBPC/CBPY codes are
        SOFT — the automaton runs the host's GOB-resync scan in-lane
        (round 4; frame.py:193-207 / gob.rs:21-42): no start code within
        realignment distance, or EOF during the scan, or a picture
        boundary (GN 0/15) all end the picture tail-filled; a real GOB
        header (GN 1..14) fails the frame with UnimplementedDecoding,
        matching the reference's deliberate GOB stub.  Every other error
        class (MVD/DC/TCOEF/escape/beyond-count/unimplemented) hard-fails
        the frame for both flavors (error.rs:82-85: only those two
        classes trigger resync).
        UMV flag bits (encode_ptype derives them from the CARRIED running
        options + this picture's header, mirroring the host's
        decode_motion_vector / halfpel_decode gates):
          bit 3 (+8): Annex-D UMV without PLUSPTYPE — Table-14 MVDs, but
            the no-wraparound-when-predictor-in-standard-range rule and
            the 64-halfpel fallback range (mvd_pred.rs:70-117).
          bit 4 (+16): UMV with PLUSPTYPE — MVDs use the table-D.3 fixed
            codes (reader.rs:298-324), ONE component per automaton
            iteration (a component spans up to 25 bits).
          bit 5 (+32): motion_vector_range == EXTENDED — the wraparound
            range comes from the picture dims (static per program;
            `width`/`height` args, defaulting to 16*mbw/16*mbh).
      sorenson_v1: int32 [S] — 1 selects the flag-chosen 7/11-bit escape
        level (block.rs:693-709); 0 the 8-bit form (incl. standard).
      mbh, mbw: static macroblock grid dims.

    Emissions per step: coe_ord/coe_val (one coefficient or sentinel),
    rec_idx/rec_val (one MV/discard record or sentinel), all int32 [S].
    """
    import jax
    import jax.numpy as jnp

    if base is None:
        S, Lw = data_u32.shape
    else:
        (Nw,) = data_u32.shape
        S = base.shape[0]
    nmb = mbh * mbw
    RING = mbw + 2
    # Static EXTENDED-UMV wraparound ranges (D.1/D.2, keyed to the picture
    # size) — the automaton compiles per picture bucket, so these are
    # Python constants (mvpred._extended_range_for_dim / mvd_pred.rs:94-109).
    from .mvpred import _extended_range_for_dim

    EXT_RNG_X = _extended_range_for_dim(width if width else 16 * mbw, True)
    EXT_RNG_Y = _extended_range_for_dim(height if height else 16 * mbh, False)

    if tables is None:
        tables = dict(mcbpc_i=jnp.asarray(MCBPC_I_ARR),
                      mcbpc_p=jnp.asarray(MCBPC_P_ARR),
                      cbpy=jnp.asarray(CBPY_ARR),
                      mvd=jnp.asarray(MVD_ARR),
                      tcoef=jnp.asarray(TCOEF_ARR))
    mcbpc_i = tables["mcbpc_i"]
    mcbpc_p = tables["mcbpc_p"]
    cbpy_t = tables["cbpy"]
    mvd_t = tables["mvd"]
    tcoef_t = tables["tcoef"]

    u32 = lambda x: x.astype(jnp.uint32)
    i32 = lambda x: x.astype(jnp.int32)

    data_u32 = u32(data_u32)
    nbits = i32(nbits)

    ORD_SENTINEL = jnp.int32(2 ** 30)
    REC_SENTINEL = jnp.int32(2 ** 30)

    if base is None:
        def fetch_word(wcur):
            w = jnp.take_along_axis(
                data_u32, jnp.clip(wcur, 0, Lw - 1)[:, None], axis=1)[:, 0]
            return jnp.where(wcur < Lw, w, jnp.uint32(0))
    else:
        base_i = i32(base)
        lane_words = (nbits + 31) // 32

        def fetch_word(wcur):
            # Clip wcur to >= 0 BEFORE adding base: the rows layout clips
            # into the lane's own row, so a (currently unreachable)
            # negative wcur must read this lane's word 0 here too, not a
            # previous lane's tail — the two layouts stay identical under
            # all inputs.
            idx = jnp.clip(base_i + jnp.maximum(wcur, 0), 0, Nw - 1)
            w = jnp.take(data_u32, idx)
            return jnp.where(wcur < lane_words, w, jnp.uint32(0))

    def refill(st):
        """Maintain the 64-bit (hi, lo) window: while fewer than 33 window
        bits are valid, pull in the next 32-bit word.  One conditional pull
        per iteration suffices given max consumption 26 bits (see invariant
        note in module docs)."""
        need = st["valid"] <= 32
        w = fetch_word(st["wcur"])
        hi = jnp.where(need, st["hi"] | _shr32(w, st["valid"]), st["hi"])
        lo = jnp.where(need, st["lo"] | _shl32(w, 32 - st["valid"]), st["lo"])
        return dict(st, hi=hi, lo=lo,
                    valid=jnp.where(need, st["valid"] + 32, st["valid"]),
                    wcur=jnp.where(need, st["wcur"] + 1, st["wcur"]))

    def consume(st, n, active):
        n = jnp.where(active, n, 0)
        hi = _shl32(st["hi"], n) | _shr32(st["lo"], 32 - n)
        lo = _shl32(st["lo"], n)
        return dict(st, hi=hi, lo=lo, valid=st["valid"] - n,
                    bitpos=st["bitpos"] + n)

    def ring_fetch(ring, idx):
        """ring [S, RING, 8] at per-lane MB index (modulo RING).  Indices
        may be negative for guarded-off candidates; clamp for safety."""
        slot = jnp.clip(idx, 0, None) % RING
        return jnp.take_along_axis(
            ring, slot[:, None, None].repeat(8, axis=2), axis=1)[:, 0, :]

    def ring_store(ring, mb, quad):
        slot = (mb % RING)[:, None, None]
        iota = jax.lax.broadcasted_iota(jnp.int32, (S, RING, 8), 1)
        return jnp.where(iota == slot, quad[:, None, :], ring)

    # -- block sequencing ---------------------------------------------------

    def next_coded_block(cbp, is_intra, from_blk):
        """Smallest block index >= from_blk that the block loop visits:
        INTRA MBs visit every block (INTRADC is unconditional); INTER MBs
        only blocks with a CBP bit (state.rs:287-381).  Returns 6 = done."""
        import jax.numpy as jnp

        nxt = jnp.full_like(from_blk, 6)
        for b in range(5, -1, -1):
            hit = (from_blk <= b) & (is_intra | ((cbp >> b) & 1) == 1)
            nxt = jnp.where(hit, b, nxt)
        return nxt

    # -- per-phase step functions -------------------------------------------
    # Each returns (new_state_fields, emissions); everything is computed for
    # every lane and selected by phase at the end of the body.

    def enter_blocks(st, upd, mb_vec, cbp, mtype):
        """Transition after the MB header/MVDs: find the first coded block
        or finish the MB.  `mb_vec` is the (already current) MB index."""
        is_intra = (mtype == _MT_INTRA) | (mtype == _MT_INTRA_Q)
        b0 = next_coded_block(cbp, is_intra, jnp.zeros_like(cbp))
        done = b0 >= 6
        phase = jnp.where(done, PH_HEADER,
                          jnp.where(is_intra, PH_DC, PH_COEF))
        upd["mb"] = jnp.where(done, mb_vec + 1, mb_vec)
        upd["blk"] = jnp.where(done, 0, b0)
        upd["zz"] = jnp.zeros_like(b0)
        upd["blk_discard"] = jnp.zeros_like(b0)
        return phase, upd

    def advance_block(st, upd):
        """After a block completes: next coded block or next MB."""
        is_intra = (st["mtype"] == _MT_INTRA) | (st["mtype"] == _MT_INTRA_Q)
        nb = next_coded_block(st["cbp"], is_intra, st["blk"] + 1)
        done = nb >= 6
        phase = jnp.where(done, PH_HEADER,
                          jnp.where(is_intra, PH_DC, PH_COEF))
        upd["mb"] = jnp.where(done, st["mb"] + 1, st["mb"])
        upd["blk"] = jnp.where(done, 0, nb)
        upd["zz"] = jnp.zeros_like(nb)
        upd["blk_discard"] = jnp.zeros_like(nb)
        return phase, upd

    def step(st):
        st = refill(st)
        hi = st["hi"]
        rem = nbits - st["bitpos"]
        phase = st["phase"]
        active = phase < PH_DONE

        # Default emissions: sentinels (dropped by the scatters).
        coe_ord = jnp.full((S,), ORD_SENTINEL)
        coe_val = jnp.zeros((S,), jnp.int32)
        rec_idx = jnp.full((S,), REC_SENTINEL)
        rec_val = jnp.zeros((S,), jnp.int32)
        rec_flg = jnp.zeros((S,), jnp.int32)

        new_phase = phase
        new_status = st["status"]
        consumed = jnp.zeros((S,), jnp.int32)
        upd = {k: st[k] for k in
               ("mb", "blk", "zz", "quant", "cbp", "mtype", "mvd_k",
                "n_mvd", "blk_discard", "mvd_c", "mvd_xtmp")}
        cur_quad = st["cur_quad"]
        ring = st["ring"]

        mb = st["mb"]
        in_hdr = active & (phase == PH_HEADER)
        in_mvd = active & (phase == PH_MVD)
        in_dc = active & (phase == PH_DC)
        in_coef = active & (phase == PH_COEF)

        # ================= HEADER (macroblock.rs:445-549) ==================
        is_std = (ptype & 4) != 0     # standard (non-Sorenson) lane
        pt = ptype & 3
        umv1 = (ptype & 8) != 0       # Annex-D UMV without PLUSPTYPE
        d3l = (ptype & 16) != 0       # PLUSPTYPE UMV: table-D.3 MVD codes
        extl = (ptype & 32) != 0      # motion_vector_range == EXTENDED
        mq_l = (ptype & 64) != 0      # MODIFIED_QUANTIZATION carried
        is_p_like = pt != 0
        cod_bits = jnp.where(is_p_like, 1, 0)
        cod = jnp.where(is_p_like, i32(_peek(hi, 0, 1)), 0)
        uncoded = is_p_like & (cod == 1)
        c0 = cod_bits

        # Coded MB in a non-I/P picture: UnimplementedDecoding raised
        # BEFORE any MCBPC read (macroblock.rs:461-464), so no later read's
        # EOF can mask it.
        h_unimpl = (~uncoded) & (pt == 2)
        reads_on = (~uncoded) & ~h_unimpl           # header reads continue

        entI, lenI = _lookup(mcbpc_i, MCBPC_I_LEN, hi, c0)
        entP, lenP = _lookup(mcbpc_p, MCBPC_P_LEN, hi, c0)
        ent_m = jnp.where(pt == 0, entI, entP)
        len_m = jnp.where(pt == 0, lenI, lenP)
        # EOF/invalid precedence is staged in read order, matching the
        # sequential bitio reads: an invalid code with sufficient bits fails
        # the frame immediately — a later field's EOF must not turn that
        # into a tail-fill picture end.
        e_cod = cod_bits > rem
        e_m = reads_on & ~e_cod & (c0 + len_m > rem)
        h_bad_m = reads_on & ~e_cod & ~e_m & ((ent_m >> 25) & 1 == 1)
        stuffing = reads_on & ~e_cod & ~e_m & ~h_bad_m & ((ent_m >> 24) & 1 == 1)
        mtype = ent_m & 7
        cbc = (ent_m >> 3) & 1
        crc = (ent_m >> 4) & 1
        c1 = c0 + jnp.where(reads_on, len_m, 0)
        is_intra_t = (mtype == _MT_INTRA) | (mtype == _MT_INTRA_Q)

        rd_y = reads_on & ~stuffing & ~e_cod & ~e_m & ~h_bad_m
        ent_y, len_y = _lookup(cbpy_t, CBPY_LEN, hi, c1)
        e_y = rd_y & (c1 + len_y > rem)
        h_bad_y = rd_y & ~e_y & ((ent_y >> 25) & 1 == 1)
        cbpy_bits = ent_y & 0xF
        luma_bits = jnp.where(is_intra_t, cbpy_bits, cbpy_bits ^ 0xF)
        c2 = c1 + jnp.where(reads_on & ~stuffing, len_y, 0)

        has_q = ((mtype == _MT_INTER_Q) | (mtype == _MT_INTRA_Q)
                 | (mtype == _MT_INTER_4V_Q))
        dq_bits = jnp.where(reads_on & ~stuffing & has_q, 2, 0)
        # MODIFIED_QUANTIZATION: the host raises UnimplementedDecoding on
        # every coded non-stuffing MB AFTER the CBPY decode and BEFORE the
        # DQUANT read (macroblock.rs:497-498) — so a CBPY error keeps its
        # own class, and a would-be DQUANT EOF cannot turn the MQ error
        # into a tail-filled picture end (the read is never attempted).
        h_mq = rd_y & ~e_y & ~h_bad_y & mq_l
        e_dq = rd_y & ~e_y & ~h_bad_y & ~h_mq & (c2 + dq_bits > rem)
        h_eof = e_cod | e_m | e_y | e_dq
        dqb = i32(_peek(hi, c2, 2))
        dq = jnp.where(dqb == 0, -1,
                       jnp.where(dqb == 1, -2, jnp.where(dqb == 2, 1, 2)))
        dq = jnp.where(dq_bits == 2, dq, 0)   # only _Q types carry DQUANT
        c3 = c2 + dq_bits
        new_q = jnp.clip(st["quant"] + dq, 1, 31)

        cbp6 = luma_bits | (cbc << 4) | (crc << 5)
        is_inter_t = ~is_intra_t
        is_4v = (mtype == _MT_INTER_4V) | (mtype == _MT_INTER_4V_Q)

        # Errors/EOF resolve in read order: EOF anywhere in the header ends
        # the picture (decode_macroblock is transactional, so no side
        # effects are kept — hence all header effects below are gated on
        # ~h_eof).  Errors fail the frame.
        h_err = jnp.where(h_bad_m, ST_BAD_MCBPC,
                          jnp.where(h_bad_y, ST_BAD_CBPY, 0))
        h_err = jnp.where(h_unimpl & ~h_eof, ST_UNIMPLEMENTED, h_err)
        h_err = jnp.where(h_mq, ST_UNIMPLEMENTED, h_err)

        # Beyond-MB-count check for INTRA MBs (no MVD phase follows); the
        # inter case is checked at MVD completion (frame.py:234-240 runs
        # after decode_macroblock returns, i.e. after the MVDs).
        h_beyond = (~uncoded) & ~stuffing & is_intra_t & (mb >= nmb)
        h_err = jnp.where(h_beyond & ~h_eof & (h_err == 0), ST_BEYOND_NMB, h_err)

        # Standard lanes: invalid MCBPC/CBPY are macroblock-class errors
        # (error.rs:82-85) — the host resyncs via decode_gob
        # (frame.py:193-207, picture.py:467-485, gob.rs:21-42).  The MB
        # decode is transactional, so the scan starts at this MB's first
        # bit (nothing is consumed on the error paths): candidates
        # s = 0..align+1 stuffing zeros ahead (recognize_start_code's
        # reference off-by-one, bitio.py:104-110), first outcome in scan
        # order wins:
        #   s+17 > rem         -> EOF mid-peek       -> tail-filled end
        #   17-bit code at s   -> read GN (5 bits):
        #       s+22 > rem     -> EOF                -> tail-filled end
        #       GN in {0, 15}  -> picture boundary   -> tail-filled end
        #       GN in 1..14    -> real GOB header    -> UnimplementedDecoding
        #                         (gob stub parity — the frame FAILS)
        #   no code in range   -> InvalidGobHeader   -> tail-filled end
        # s+22 <= 30 <= 32 and valid >= 33 here, so one `hi` peek covers
        # the whole scan; window bits past nbits are zero-padding, hence
        # every peek is gated on `rem` first.  All other error classes
        # stay hard for both flavors.
        h_soft = is_std & (h_bad_m | h_bad_y)
        align = (8 - (st["bitpos"] & 7)) & 7
        g_dec = jnp.zeros((S,), jnp.int32)  # 0 undecided / 1 tail / 2 fail
        for s_c in range(9):
            g_eof = s_c + 17 > rem
            g_code = _peek(hi, s_c, 17) == 1
            gn = _peek(hi, s_c + 17, 5)
            g_gn_ends = (s_c + 22 > rem) | (gn == 0) | (gn == 15)
            take = (g_dec == 0) & (s_c <= align + 1)
            g_dec = jnp.where(
                take & (g_eof | (g_code & g_gn_ends)), 1, g_dec)
            g_dec = jnp.where(
                take & ~g_eof & g_code & ~g_gn_ends, 2, g_dec)
        h_soft_fail = h_soft & (g_dec == 2)
        h_soft_tail = h_soft & ~h_soft_fail
        h_err = jnp.where(h_soft_fail, ST_UNIMPLEMENTED, h_err)
        h_fail = ((h_err != 0) & ~h_eof & ~h_soft) | h_soft_fail
        h_ok = ~h_eof & ~h_soft & ~h_fail

        # Header-phase results --------------------------------------------
        hdr_consumed = jnp.where(
            h_eof | h_soft, 0,
            jnp.where(uncoded, 1, jnp.where(stuffing, c1, c3)))
        hdr_phase = jnp.where(h_eof | h_soft_tail, PH_DONE,
                              jnp.where(h_fail, PH_ERR, PH_HEADER))
        # (coded-MB phase transitions applied below via enter_blocks / MVD)

        # Uncoded MB: INTER, zero MV (frame.py:209-212); ring gets zeros.
        zeroq = jnp.zeros((S, 8), jnp.int32)
        hdr_quad = jnp.where((h_ok & uncoded)[:, None], 0, cur_quad)
        hdr_ring = jnp.where((h_ok & uncoded)[:, None, None],
                             ring_store(ring, mb, zeroq), ring)
        hdr_rec_idx = jnp.where(
            h_ok & uncoded & (mb < nmb), mb, REC_SENTINEL)
        hdr_rec_val = jnp.zeros((S,), jnp.int32)      # zero MV pair
        hdr_rec_flg = jnp.full((S,), _FLG_PRESENT | _FLG_INTER, jnp.int32)
        hdr_mb = jnp.where(h_ok & uncoded, mb + 1, mb)

        # INTRA MB: record inter=0 now; quad = zeros (frame.py:205,262-268).
        intra_now = h_ok & ~uncoded & ~stuffing & is_intra_t
        hdr_quad = jnp.where(intra_now[:, None], 0, hdr_quad)
        hdr_ring = jnp.where(intra_now[:, None, None],
                             ring_store(hdr_ring, mb, zeroq), hdr_ring)
        hdr_rec_idx = jnp.where(intra_now & (mb < nmb), mb, hdr_rec_idx)
        hdr_rec_flg = jnp.where(intra_now, _FLG_PRESENT, hdr_rec_flg)

        # Coded-MB phase transition.
        coded_ok = h_ok & ~uncoded & ~stuffing
        upd_hdr = dict(upd)
        upd_hdr["quant"] = jnp.where(coded_ok, new_q, st["quant"])
        upd_hdr["cbp"] = jnp.where(coded_ok, cbp6, st["cbp"])
        upd_hdr["mtype"] = jnp.where(coded_ok, mtype, st["mtype"])
        upd_hdr["mvd_k"] = jnp.zeros_like(mb)
        upd_hdr["mvd_c"] = jnp.zeros_like(mb)
        upd_hdr["n_mvd"] = jnp.where(is_4v, 4, 1)
        upd_hdr["mb"] = hdr_mb

        # intra -> blocks; inter -> MVD phase.
        eb_phase, upd_hdr2 = enter_blocks(
            st, dict(upd_hdr), mb, cbp6, mtype)
        hdr_phase = jnp.where(coded_ok & is_intra_t, eb_phase, hdr_phase)
        hdr_phase = jnp.where(coded_ok & is_inter_t, PH_MVD, hdr_phase)
        for k in upd_hdr2:
            upd_hdr[k] = jnp.where((coded_ok & is_intra_t),
                                   upd_hdr2[k], upd_hdr[k])

        # ================= MVD (macroblock.rs:414-437, mvd_pred.rs) =======
        # Two code families: Table-14 VLC (one PAIR per iteration) or —
        # UMV pictures with PLUSPTYPE — table-D.3 fixed codes
        # (reader.rs:298-324), one COMPONENT per iteration: a D.3 code
        # spans up to 25 bits, so a pair would blow the 26-bit
        # consumption invariant.  st["mvd_c"] tracks the pending
        # component; st["mvd_xtmp"] stashes x until y completes the pair.
        ent_x, len_x = _lookup(mvd_t, MVD_LEN, hi, jnp.zeros((S,), jnp.int32))
        # Staged EOF/invalid precedence (see header note): InvalidMvd fails
        # the frame (Sorenson has no GOB resync), EOF tail-fills — the x
        # read resolves before the y read is considered.
        t_eof_x = len_x > rem
        t_bad_x = ~t_eof_x & ((ent_x >> 25) & 1 == 1)
        t_mvdx = _sign8(ent_x)
        ent_y2, len_y2 = _lookup(mvd_t, MVD_LEN, hi, len_x)
        t_eof_y = ~t_eof_x & ~t_bad_x & (len_x + len_y2 > rem)
        t_bad_y = (~t_eof_x & ~t_bad_x & ~t_eof_y
                   & ((ent_y2 >> 25) & 1 == 1))
        tab_eof = t_eof_x | t_eof_y
        tab_bad = t_bad_x | t_bad_y
        t_mvdy = _sign8(ent_y2)
        tab_consumed = len_x + len_y2

        # --- table-D.3 component (reader.rs:298-324): first bit 1 -> 0;
        # else 2-bit rounds at static offsets 1+2i — 00 terminates +,
        # 10 terminates -, 01/11 extend the mantissa; 12 extender rounds
        # without a terminator is InvalidMvd (|value| >= 4096).  The
        # rounds' offsets are static, so the whole read is a 12-step
        # unrolled select chain over one window peek each.
        d3_found = i32(_peek(hi, 0, 1)) == 1          # the zero code
        d3_val = jnp.zeros((S,), jnp.int32)
        d3_len = jnp.ones((S,), jnp.int32)
        d3_mant = jnp.zeros((S,), jnp.int32)
        d3_bulk = jnp.ones((S,), jnp.int32)
        for d3_i in range(12):
            d3_code = i32(_peek(hi, 1 + 2 * d3_i, 2))
            d3_stop = ~d3_found & ((d3_code == 0b00) | (d3_code == 0b10))
            d3_mag = d3_mant + d3_bulk
            d3_val = jnp.where(
                d3_stop, jnp.where(d3_code == 0b10, -d3_mag, d3_mag), d3_val)
            d3_len = jnp.where(d3_stop, 1 + 2 * (d3_i + 1), d3_len)
            d3_found = d3_found | d3_stop
            d3_mant = jnp.where(d3_found, d3_mant,
                                (d3_mant << 1) | ((d3_code >> 1) & 1))
            d3_bulk = jnp.where(d3_found, d3_bulk, d3_bulk << 1)
        d3_len = jnp.where(d3_found, d3_len, 25)
        # EOF resolves at the first 2-bit round crossing the valid-bit
        # boundary, which is exactly len > rem (rounds strictly inside rem
        # read only real bits; a crossing round's length already exceeds
        # rem).  Invalid fires only once all 25 bits proved readable.
        d3_eof = d3_len > rem
        d3_bad = ~d3_eof & ~d3_found

        # --- merge the two families.
        comp_y = st["mvd_c"] == 1
        m_eof = jnp.where(d3l, d3_eof, tab_eof)
        m_bad = jnp.where(d3l, d3_bad, tab_bad)
        mvdx = jnp.where(d3l, jnp.where(comp_y, st["mvd_xtmp"], d3_val),
                         t_mvdx)
        mvdy = jnp.where(d3l, d3_val, t_mvdy)
        mvd_consumed = jnp.where(d3l, d3_len, tab_consumed)
        # Does THIS iteration complete an (x, y) pair?
        pair_now = jnp.where(d3l, comp_y, True)

        k = jnp.where(st["n_mvd"] == 4, st["mvd_k"], 0)
        col = mb % mbw
        line = mb // mbw
        eol = col == (mbw - 1)
        left = ring_fetch(ring, mb - 1)
        above = ring_fetch(ring, mb - mbw)
        abover = ring_fetch(ring, mb - mbw + 1)

        def cand(comp):
            # mv1/mv2/mv3 per mvpred.py::predict_candidate (mvd_pred.rs:27-67).
            # `comp` is a static 0 (x) / 1 (y); `k` is the per-lane block
            # index (always 0 for non-4V MBs).
            cq = cur_quad
            k_even = (k == 0) | (k == 2)      # left neighbor is previous MB
            k_top = (k == 0) | (k == 1)       # above row neighbors apply
            mv1 = jnp.where(
                k_even,
                jnp.where(col == 0, 0,
                          jnp.take_along_axis(
                              left, ((k + 1) * 2 + comp)[:, None], axis=1)[:, 0]),
                jnp.take_along_axis(
                    cq, ((k - 1) * 2 + comp)[:, None], axis=1)[:, 0])
            up = jnp.take_along_axis(
                above, ((k + 2) * 2 + comp)[:, None], axis=1)[:, 0]
            mv2 = jnp.where(
                k_top,
                jnp.where(line == 0, mv1, up),
                cq[:, comp])                  # blocks 2/3: current block 0
            mv3 = jnp.where(
                k_top,
                jnp.where(eol, 0,
                          jnp.where(line == 0, mv1, abover[:, 4 + comp])),
                cq[:, 2 + comp])              # blocks 2/3: current block 1
            return jnp.maximum(jnp.minimum(mv1, mv2),
                               jnp.minimum(jnp.maximum(mv1, mv2), mv3))

        predx = cand(0)
        predy = cand(1)

        def halfpel(pred, mvd, ext_rng):
            # mvpred.halfpel_decode (mvd_pred.rs:70-117): predictor + MVD
            # with restricted-range ±64 wraparound.  UMV variants: v1
            # (umv1) returns pred+mvd UNwrapped when the predictor is in
            # the standard range and widens the fallback range to 64;
            # PLUSPTYPE UMV with EXTENDED motion_vector_range (extl) uses
            # the static per-dims range (ext_rng; UNLIMITED keeps the
            # standard range — the reference's match falls through).
            # The commit wraps to int16, matching the native parser's
            # int16_t MV/predictor stores (see _sign16).
            out = pred + mvd
            inv = jnp.where(mvd > 0, mvd - 64, jnp.where(mvd < 0, mvd + 64, 0))
            wrapped = pred + inv
            rng = jnp.where(umv1, 64, jnp.where(extl, ext_rng, 32))
            in_range = (out >= -rng) & (out < rng)
            v1_early = umv1 & (pred >= -32) & (pred < 32)
            return _sign16(jnp.where(v1_early | in_range, out, wrapped))

        mvx = halfpel(predx, mvdx, EXT_RNG_X)
        mvy = halfpel(predy, mvdy, EXT_RNG_Y)

        m_ok = in_mvd & ~m_eof & ~m_bad       # this component/pair read ok
        pair_ok = m_ok & pair_now             # a full (x, y) pair decoded
        is4v_mb = st["n_mvd"] == 4
        # Update the current quad: non-4V -> all four blocks; 4V -> block k.
        iota8 = jax.lax.broadcasted_iota(jnp.int32, (S, 8), 1)
        newq_all = jnp.where(iota8 % 2 == 0, mvx[:, None], mvy[:, None])
        hit_k = (iota8 >> 1) == k[:, None]
        mvd_quad = jnp.where(
            (pair_ok & ~is4v_mb)[:, None], newq_all,
            jnp.where((pair_ok & is4v_mb)[:, None] & hit_k,
                      newq_all, cur_quad))

        last_mvd = st["mvd_k"] == (st["n_mvd"] - 1)
        mvd_complete = pair_ok & last_mvd

        # Beyond-nmb check at MVD completion (see header note).
        # ANY coded MB past the count is rejected (rle.rs:90 panics even
        # for empty-CBP INTER MBs); flagged after MVD completes so the
        # error class matches the host parsers' ordering.
        m_beyond = mvd_complete & (mb >= nmb)
        mvd_fail = (in_mvd & m_bad & ~m_eof) | m_beyond
        mvd_status = jnp.where(m_beyond, ST_BEYOND_NMB, ST_BAD_MVD)

        # Records: non-4V -> mb-record with broadcast MV; 4V k<3 ->
        # block-record; 4V k==3 -> mb-record carrying block 3's MV.
        mvd_rec_idx = jnp.where(
            mvd_complete & (mb < nmb), mb,
            jnp.where(pair_ok & is4v_mb & ~last_mvd & (mb < nmb),
                      nmb + mb * 3 + k, REC_SENTINEL))
        mvd_rec_val = _pack_mv_record(mvx, mvy)
        mvd_rec_flg = _pack_mv_flags(
            jnp.ones((S,), jnp.int32), jnp.where(is4v_mb, 1, 0))

        mvd_ring = jnp.where(
            mvd_complete[:, None, None],
            ring_store(ring, mb, mvd_quad), ring)

        upd_mvd = dict(upd)
        # Pair bookkeeping: mvd_k counts PAIRS; the D.3 x-component
        # iteration only stashes x and flips mvd_c.
        upd_mvd["mvd_k"] = st["mvd_k"] + jnp.where(pair_now, 1, 0)
        upd_mvd["mvd_c"] = jnp.where(pair_now, 0, 1)
        upd_mvd["mvd_xtmp"] = jnp.where(pair_now, st["mvd_xtmp"], d3_val)
        eb_phase_m, upd_mvd2 = enter_blocks(
            st, dict(upd_mvd), mb, st["cbp"], st["mtype"])
        mvd_phase = jnp.where(
            m_eof, PH_DONE,
            jnp.where(mvd_fail, PH_ERR,
                      jnp.where(mvd_complete, eb_phase_m, PH_MVD)))
        for kk in upd_mvd2:
            upd_mvd[kk] = jnp.where(mvd_complete, upd_mvd2[kk], upd_mvd[kk])

        # ================= INTRADC (block.rs:682-686, types.rs:923-962) ====
        d_eof = rem < 8
        dcv = i32(_peek(hi, 0, 8))
        d_bad = (dcv == 0) | (dcv == 128)
        dcval = jnp.where(dcv == 255, 1024, dcv << 3)
        dc_ok = in_dc & ~d_eof & ~d_bad
        dc_ord = mb * 384 + st["blk"] * 64  # zigzag position 0
        dc_has_coef = (st["cbp"] >> st["blk"]) & 1 == 1
        upd_dc = dict(upd)
        upd_dc["zz"] = jnp.ones_like(mb)
        adv_phase, upd_dc2 = advance_block(st, dict(upd_dc))
        dc_phase = jnp.where(
            d_eof | d_bad, PH_ERR,
            jnp.where(dc_has_coef, PH_COEF, adv_phase))
        for kk in upd_dc2:
            upd_dc[kk] = jnp.where(dc_ok & ~dc_has_coef, upd_dc2[kk], upd_dc[kk])
        dc_status = jnp.where(d_eof, ST_EOF_IN_BLOCK, ST_BAD_INTRADC)

        # ================= TCOEF (block.rs:670-755, rle.rs:82-172) =========
        ent_t, len_t = _lookup(tcoef_t, TCOEF_LEN, hi, jnp.zeros((S,), jnp.int32))
        t_escape = (ent_t >> 24) & 1 == 1
        t_bad = (ent_t >> 25) & 1 == 1
        # Short path: sign bit follows the code.
        sgn = i32(_peek(hi, len_t, 1))
        short_last = (ent_t >> 11) & 1
        short_run = (ent_t >> 5) & 63
        short_mag = ent_t & 31
        short_consumed = len_t + 1
        # Escape path: [v1: width flag] LAST RUN LEVEL (block.rs:693-709).
        flag = i32(_peek(hi, 7, 1))
        esc_off = 7 + jnp.where(sorenson_v1 == 1, 1, 0)
        esc_w = jnp.where(sorenson_v1 == 1, jnp.where(flag == 1, 11, 7), 8)
        esc_last = i32(_peek(hi, esc_off, 1))
        esc_run = i32(_peek(hi, esc_off + 1, 6))
        lvl_raw = i32(_peek(hi, esc_off + 7, esc_w))
        sign_bit = _shl32(jnp.uint32(1), esc_w - 1).astype(jnp.int32)
        esc_level = lvl_raw - ((lvl_raw & sign_bit) << 1)
        esc_consumed = esc_off + 7 + esc_w

        t_consumed = jnp.where(t_escape, esc_consumed, short_consumed)
        # EOF precedence follows bitio: the VLC read itself first (len_t);
        # an invalid code with sufficient bits reports InvalidShort, not
        # EOF; the trailing fixed-length reads only exhaust for valid codes.
        t_eof = (len_t > rem) | (~t_bad & (t_consumed > rem))
        t_esc_zero = t_escape & (esc_level == 0)

        last = jnp.where(t_escape, esc_last, short_last)
        run = jnp.where(t_escape, esc_run, short_run)
        mag = jnp.where(t_escape, jnp.abs(esc_level), short_mag)
        neg = jnp.where(t_escape, esc_level < 0, sgn == 1)

        parity = (st["quant"] & 1) - 1
        # rle.rs:130-133 computes in i16 and WRAPS (release builds) for
        # Sorenson v1 11-bit escape levels: replicate by round-tripping
        # each step through int16 before the clamp (host parsers match).
        dqv = (st["quant"] * (2 * mag + 1)).astype(jnp.int16)
        dqv = (dqv.astype(jnp.int32) + parity).astype(jnp.int16)
        signed = jnp.where(neg, -dqv.astype(jnp.int32),
                           dqv.astype(jnp.int32)).astype(jnp.int16)
        val = jnp.clip(signed.astype(jnp.int32), -2048, 2047)

        zz_new = st["zz"] + run
        overflow = zz_new >= 64
        first_overflow = overflow & (st["blk_discard"] == 0)
        t_ok = in_coef & ~t_eof & ~t_bad & ~t_esc_zero
        emit_coef = t_ok & ~overflow & (st["blk_discard"] == 0)

        coef_ord = mb * 384 + st["blk"] * 64 + jnp.minimum(zz_new, 63)
        coef_rec_idx = jnp.where(t_ok & first_overflow,
                                 4 * nmb + mb * 6 + st["blk"], REC_SENTINEL)
        # Any nonzero value marks the discard slot (assemble reads != 0).
        coef_rec_val = jnp.ones((S,), jnp.int32)

        upd_coef = dict(upd)
        upd_coef["zz"] = jnp.minimum(zz_new + 1, 64)
        upd_coef["blk_discard"] = jnp.where(overflow, 1, st["blk_discard"])
        adv_phase_c, upd_coef2 = advance_block(st, dict(upd_coef))
        t_done = t_ok & (last == 1)
        coef_phase = jnp.where(
            t_eof | t_bad | t_esc_zero, PH_ERR,
            jnp.where(t_done, adv_phase_c, PH_COEF))
        for kk in upd_coef2:
            upd_coef[kk] = jnp.where(t_done, upd_coef2[kk], upd_coef[kk])
        coef_status = jnp.where(
            t_eof, ST_EOF_IN_BLOCK,
            jnp.where(t_bad, ST_BAD_TCOEF, ST_BAD_ESCAPE))

        # ================= select by phase =================================
        def sel(hdr, mvd, dc, coef, cur):
            x = jnp.where(in_hdr, hdr, cur)
            x = jnp.where(in_mvd, mvd, x)
            x = jnp.where(in_dc, dc, x)
            x = jnp.where(in_coef, coef, x)
            return x

        new_phase = sel(hdr_phase, mvd_phase, dc_phase, coef_phase, phase)
        consumed = sel(hdr_consumed, jnp.where(m_eof, 0, mvd_consumed),
                       jnp.where(d_eof, 0, 8),
                       jnp.where(t_eof, 0, t_consumed), consumed)
        # NB: consumed bits on the DONE paths are irrelevant (lane halts);
        # zeroed to keep bitpos <= nbits.  Error paths likewise halt.
        err_status = sel(
            jnp.where(h_fail, h_err, 0),
            jnp.where(mvd_fail, mvd_status, 0),
            jnp.where(in_dc & (d_eof | d_bad), dc_status, 0),
            jnp.where(in_coef & (t_eof | t_bad | t_esc_zero), coef_status, 0),
            jnp.zeros((S,), jnp.int32))
        new_status = jnp.where((new_phase == PH_ERR) & (st["status"] == 0),
                               err_status, st["status"])

        new_upd = {}
        for kk in upd:
            new_upd[kk] = sel(upd_hdr[kk], upd_mvd[kk], upd_dc[kk],
                              upd_coef[kk], st[kk])
        new_quad = jnp.where(in_hdr[:, None], hdr_quad,
                             jnp.where(in_mvd[:, None], mvd_quad, cur_quad))
        new_ring = jnp.where(
            in_hdr[:, None, None], hdr_ring,
            jnp.where(in_mvd[:, None, None], mvd_ring, ring))

        coe_ord = sel(coe_ord, coe_ord, jnp.where(dc_ok, dc_ord, coe_ord),
                      jnp.where(emit_coef, coef_ord, coe_ord), coe_ord)
        coe_val = sel(coe_val, coe_val, jnp.where(dc_ok, dcval, coe_val),
                      jnp.where(emit_coef, val, coe_val), coe_val)
        rec_idx = sel(hdr_rec_idx, mvd_rec_idx, rec_idx, coef_rec_idx, rec_idx)
        rec_val = sel(hdr_rec_val, mvd_rec_val, rec_val, coef_rec_val, rec_val)
        rec_flg = sel(hdr_rec_flg, mvd_rec_flg, rec_flg, rec_flg, rec_flg)

        st2 = dict(st, phase=new_phase, status=new_status,
                   cur_quad=new_quad, ring=new_ring, **new_upd)
        st2 = consume(st2, consumed, active)

        return st2, dict(coe_ord=coe_ord, coe_val=coe_val,
                         rec_idx=rec_idx, rec_val=rec_val, rec_flg=rec_flg)

    def init_state(start_bit, quant0):
        start_bit = i32(start_bit)
        zeros = jnp.zeros((S,), jnp.int32)
        st0 = dict(
            phase=zeros, bitpos=zeros, valid=zeros,
            hi=jnp.zeros((S,), jnp.uint32), lo=jnp.zeros((S,), jnp.uint32),
            wcur=zeros, mb=zeros, blk=zeros, zz=zeros,
            quant=i32(quant0), cbp=zeros, mtype=zeros,
            mvd_k=zeros, n_mvd=jnp.ones((S,), jnp.int32), blk_discard=zeros,
            mvd_c=zeros, mvd_xtmp=zeros,
            status=zeros,
            cur_quad=jnp.zeros((S, 8), jnp.int32),
            ring=jnp.zeros((S, RING, 8), jnp.int32),
        )
        # Prime the window: two refills, then consume the header offset
        # within the first word pair.
        st0["wcur"] = start_bit >> 5
        st0 = refill(st0)
        st0 = refill(st0)
        st0 = consume(st0, start_bit & 31, jnp.ones((S,), bool))
        st0["bitpos"] = start_bit
        return st0

    return init_state, step


def parse_frames_device(data_u32, start_bit, nbits, quant0, ptype, sorenson_v1,
                        *, mbh: int, mbw: int, tape_len: int,
                        unroll: int = 4, base=None,
                        width=None, height=None):
    """Vectorized batched entropy decode (XLA harness around make_step).

    Returns dict with coe_ord/coe_val int32 [S, T], rec_idx/rec_val int32
    [S, T], status int32 [S], iterations int32 [] (diagnostic).  See
    make_step for argument semantics; tape_len is the static iteration
    budget T (the transport cap — exceeding lanes flag ST_TAPE_OVERFLOW).

    `unroll` runs that many automaton steps per while_loop body (one
    (S, unroll) tape block store instead of `unroll` column stores),
    amortizing the loop's per-iteration overhead — the XLA harness
    round-trips the ~20 small state arrays through HBM once per BODY.
    Finished lanes pass through extra sub-steps as masked no-ops, so any
    unroll factor is semantics-preserving; T rounds up to a multiple.
    """
    import jax
    import jax.numpy as jnp

    S = nbits.shape[0]
    U = max(1, unroll)
    T = -(-tape_len // U) * U
    init_state, step = make_step(data_u32, nbits, ptype, sorenson_v1,
                                 mbh=mbh, mbw=mbw, base=base,
                                 width=width, height=height)
    st0 = init_state(start_bit, quant0)

    tapes0 = dict(
        coe_ord=jnp.full((S, T), jnp.int32(2 ** 30)),
        coe_val=jnp.zeros((S, T), jnp.int32),
        rec_idx=jnp.full((S, T), jnp.int32(2 ** 30)),
        rec_val=jnp.zeros((S, T), jnp.int32),
        rec_flg=jnp.zeros((S, T), jnp.int32),
    )

    def body(carry):
        st, tapes, t = carry
        cols = {k: [] for k in tapes0}
        for _ in range(U):
            st, em = step(st)
            for k in cols:
                cols[k].append(em[k])
        tapes = {
            k: jax.lax.dynamic_update_slice_in_dim(
                tapes[k], jnp.stack(cols[k], axis=1), t, axis=1)
            for k in tapes
        }
        return st, tapes, t + U

    def cond(carry):
        st, _, t = carry
        return (t < T) & jnp.any(st["phase"] < PH_DONE)

    st, tapes, t = jax.lax.while_loop(cond, body, (st0, tapes0, jnp.int32(0)))

    status = jnp.where((st["phase"] < PH_DONE) & (st["status"] == 0),
                       ST_TAPE_OVERFLOW, st["status"])
    return dict(tapes, status=status, iterations=t)


# --------------------------------------------------------------------------
# Post-pass: tapes -> the packed-transport view the reconstruction program
# consumes.  Two scatters total (coefficients add-mode, records set-mode).
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _dense_block_perm(mbh: int, mbw: int):
    """inv_perm[dense_blk] = mb*6 + b, mapping the discard-flag space to the
    dense layout used by the coefficient scatter (shared with
    reconstruct.d24_to_posval): luma 2mbh x 2mbw grid row-major, then Cb,
    then Cr."""
    nmb = mbh * mbw
    inv = np.empty(6 * nmb, dtype=np.int32)
    for mb in range(nmb):
        r, c = divmod(mb, mbw)
        for b in range(4):
            dense = (2 * r + (b >> 1)) * (2 * mbw) + 2 * c + (b & 1)
            inv[dense] = mb * 6 + b
        inv[4 * nmb + mb] = mb * 6 + 4
        inv[5 * nmb + mb] = mb * 6 + 5
    return inv


def assemble(tapes, *, mbh: int, mbw: int):
    """Turn the automaton tapes into (dense, mvs, inter, ok).

    dense int16 [S, 6*nmb, 64] row-major coefficients (dezigzagged,
    dequantized, discard-masked); mvs int16 [S, mbh, mbw, 4, 2]; inter
    bool [S, mbh, mbw]; ok bool [S].  Errored/overflowed lanes are
    neutralized to the identity frame (all-INTER, zero MVs, zero
    coefficients) so the step reproduces the reference picture, matching
    the reference's failed-decode contract (state.rs:119-137).
    """
    import jax
    import jax.numpy as jnp

    from ..vlc_tables import ZIGZAG_TO_ROWMAJOR

    S = tapes["coe_ord"].shape[0]
    nmb = mbh * mbw
    nblk = 6 * nmb

    ok = tapes["status"] == ST_OK

    # Coefficient scatter (add mode; sentinel ordinals drop).  Mapping is
    # the same ordinal -> (dense block, row-major) math as the d24
    # transport (reconstruct.py::d24_to_posval), minus the delta cumsum.
    ordpos = tapes["coe_ord"]
    mb = ordpos // 384
    rem = ordpos - mb * 384
    b = rem >> 6
    zz = rem & 63
    rm = jnp.asarray(ZIGZAG_TO_ROWMAJOR, dtype=jnp.int32)[jnp.minimum(zz, 63)]
    r_ = mb // mbw
    c_ = mb - r_ * mbw
    luma_blk = (2 * r_ + (b >> 1)) * (2 * mbw) + 2 * c_ + (b & 1)
    chroma_blk = 4 * nmb + (b - 4) * nmb + r_ * mbw + c_
    blk = jnp.where(b < 4, luma_blk, chroma_blk)
    pos = jnp.where(ordpos < 6 * nmb * 64, blk * 64 + rm, nblk * 64)

    dense = jnp.zeros((S, nblk * 64), jnp.int32)
    dense = jax.vmap(lambda d, p, v: d.at[p].add(v, mode="drop"))(
        dense, pos, tapes["coe_val"])
    dense = dense.reshape(S, nblk, 64)

    # Record scatters (set mode): MV values and — same indices — the MB
    # flag plane (present/inter/4V ride in the rec_flg tape since the
    # value packs two full int16 components; see _pack_mv_record).
    staging = jnp.zeros((S, 10 * nmb), jnp.int32)
    staging = jax.vmap(lambda d, p, v: d.at[p].set(v, mode="drop"))(
        staging, tapes["rec_idx"], tapes["rec_val"])
    flgstaging = jnp.zeros((S, 10 * nmb), jnp.int32)
    flgstaging = jax.vmap(lambda d, p, v: d.at[p].set(v, mode="drop"))(
        flgstaging, tapes["rec_idx"], tapes["rec_flg"])

    mbrec = staging[:, :nmb]
    mbflg = flgstaging[:, :nmb]
    blkrec = staging[:, nmb:4 * nmb].reshape(S, nmb, 3)
    discard_mb = staging[:, 4 * nmb:] != 0          # [S, 6*nmb] in mb-space

    # Apply block discards (zigzag overflow zeroes the whole block,
    # rle.rs:125-127) — translate mb-space flags to the dense layout.
    inv = jnp.asarray(_dense_block_perm(mbh, mbw))
    discard_dense = jnp.take(discard_mb, inv, axis=1)
    dense = jnp.where(discard_dense[:, :, None], 0, dense)

    present = (mbflg & _FLG_PRESENT) != 0
    inter = jnp.where(present, (mbflg & _FLG_INTER) >> 1, 1) == 1
    is4v = present & ((mbflg & _FLG_4V) != 0)

    def unpack_xy(v):
        return _sign16(v), _sign16(v >> 16)

    bx, by = unpack_xy(mbrec)        # broadcast MV, or block 3's MV for 4V
    k0x, k0y = unpack_xy(blkrec[:, :, 0])
    k1x, k1y = unpack_xy(blkrec[:, :, 1])
    k2x, k2y = unpack_xy(blkrec[:, :, 2])

    def pick(kx, ky):
        return jnp.stack([kx, ky], axis=-1)

    bcast = pick(bx, by)[:, :, None, :]                     # [S, nmb, 1, 2]
    quad4v = jnp.stack([pick(k0x, k0y), pick(k1x, k1y),
                        pick(k2x, k2y), pick(bx, by)], axis=2)
    mvs = jnp.where(is4v[:, :, None, None], quad4v,
                    jnp.broadcast_to(bcast, (S, nmb, 4, 2)))
    mvs = jnp.where(present[:, :, None, None], mvs, 0)

    # Neutralize errored lanes: identity frame.
    okb = ok[:, None]
    dense = jnp.where(okb[:, :, None], dense, 0)
    mvs = jnp.where(okb[:, :, None, None], mvs, 0)
    inter = jnp.where(okb, inter, True)

    return (dense.astype(jnp.int16),
            mvs.reshape(S, mbh, mbw, 4, 2).astype(jnp.int16),
            inter.reshape(S, mbh, mbw), ok)


# --------------------------------------------------------------------------
# Host-side helpers: payload packing + dispatch gate
# --------------------------------------------------------------------------


def supports(picture, running_options) -> bool:
    """Dispatch gate for the device front-end — UNCONDITIONAL since round
    5.  UMV is in scope since round 4 (encode_ptype carries the
    table-D.3 / range-rule flags), GOB resync since round 4 late (the
    scan runs in-automaton), and MODIFIED_QUANTIZATION since round 5:
    the automaton raises the reference's UnimplementedDecoding at the
    first coded macroblock of an MQ picture (macroblock.rs:497-498, via
    ptype bit 64), so MQ frames no longer need a host fallback — an
    all-uncoded MQ picture decodes, exactly as the host parser does.
    Every other option is MB-layer-inert in the host parser too
    (macroblock.rs:445-549).  Kept as a function so dispatch sites keep
    their shape."""
    return True


def encode_ptype(picture, running_options=None) -> int:
    """The automaton's ptype field for a parsed picture header: bits 0-1
    the type (0 I / 1 P / 2 other), +4 for standard (non-Sorenson), plus
    the UMV flag bits (+8 v1 range rule / +16 table-D.3 codes / +32
    EXTENDED range) and +64 for MODIFIED_QUANTIZATION, all derived from
    the CARRIED running options and this picture's header — the same
    gates the host's decode_motion_vector / halfpel_decode /
    decode_macroblock apply (macroblock.rs:414-437,497-498,
    mvd_pred.rs:70-117)."""
    from ..types import MotionVectorRange, PictureOption, PictureTypeCode

    base = (0 if picture.picture_type is PictureTypeCode.I_FRAME
            else 1 if picture.picture_type is PictureTypeCode.P_FRAME else 2)
    base += 0 if picture.version is not None else 4
    if (running_options is not None
            and running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS):
        if picture.has_plusptype:
            base += 16
            if picture.motion_vector_range is MotionVectorRange.EXTENDED:
                base += 32
        else:
            base += 8
    if (running_options is not None
            and running_options & PictureOption.MODIFIED_QUANTIZATION):
        base += 64
    return base


def prepare_batch(frames: list[bytes], decoder_options,
                  previous_pictures=None, max_bytes: int | None = None,
                  running_options=None):
    """Host-side step preparation: parse each stream's picture header (the
    only host parsing the device front-end needs) and build the automaton's
    input arrays.

    Returns (inputs, pictures) where inputs is a dict of numpy arrays
    (data_u8 [S, Lw, 4], start_bit, nbits, quant0, ptype, sorenson_v1) and
    pictures the parsed Picture headers.  Raises if any stream is outside
    the device front-end's scope (callers should gate with supports()).
    """
    from ..bitio import BitReader
    from .picture import decode_picture

    S = len(frames)
    prev = previous_pictures or [None] * S
    if max_bytes is None:
        max_bytes = max(len(f) for f in frames)
    data_u8, nbits = pack_payloads(frames, max_bytes)
    start_bit = np.empty(S, dtype=np.int32)
    quant0 = np.empty(S, dtype=np.int32)
    ptype = np.empty(S, dtype=np.int32)
    v1 = np.empty(S, dtype=np.int32)
    pictures = []
    for i, buf in enumerate(frames):
        r = BitReader(buf)
        pic = decode_picture(r, decoder_options, prev[i])
        if pic is not None:
            # Gate on the CARRIED running options when the caller tracks
            # them (a plain PTYPE after a UMV OPPTYPE still runs UMV).
            from ..types import PictureOption, carry_forward_options

            running = carry_forward_options(
                pic, (running_options[i] if running_options is not None
                      else PictureOption.NONE))
        if pic is None or not supports(pic, running):
            raise ValueError(f"stream {i} outside device front-end scope")
        start_bit[i] = r.pos
        quant0[i] = pic.quantizer
        ptype[i] = encode_ptype(pic, running)
        v1[i] = 1 if pic.version == 1 else 0
        pictures.append(pic)
    return dict(data_u8=data_u8, start_bit=start_bit, nbits=nbits,
                quant0=quant0, ptype=ptype, sorenson_v1=v1), pictures


def pack_payloads(frames: list[bytes], max_bytes: int):
    """Pack per-stream frame payloads into the uint32-word layout the
    automaton reads.  Returns (data_u32 [S, Lw] uint32, nbits int32 [S]).
    Frames longer than max_bytes must be rejected by the caller."""
    S = len(frames)
    Lw = (max_bytes + 3) // 4
    out = np.zeros((S, Lw * 4), dtype=np.uint8)
    nbits = np.empty(S, dtype=np.int32)
    for i, f in enumerate(frames):
        out[i, :len(f)] = np.frombuffer(f, dtype=np.uint8)
        nbits[i] = len(f) * 8
    return out.reshape(S, Lw, 4), nbits


def payload_words(data_u8):
    """uint8 [S, Lw, 4] -> big-endian uint32 [S, Lw] (done in jnp so it can
    run on device after a single uint8 transfer)."""
    import jax.numpy as jnp

    d = data_u8.astype(jnp.uint32)
    return (d[..., 0] << 24) | (d[..., 1] << 16) | (d[..., 2] << 8) | d[..., 3]
