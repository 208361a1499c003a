"""Differential fuzzing of the two entropy front-ends.

Generates structured Sorenson frames (mixed I/P, INTER4V, both escape
widths, random quantizers), applies byte flips, truncations, cross-frame
splices, and garbage tails, and asserts the C++ front-end
(native/entropy.cpp) and the Python front-end (parser/frame.py) agree on
the outcome — identical dense tensors on success, identical error class on
failure.  This is the repo's strongest guard on the invariant that the two
parsers stay symbol-for-symbol identical, exercised beyond the
fixed cases in tests/test_native.py.

Library form of the round-2 fuzz campaign (8,250 cases, 0 mismatches);
tests run a small budget, `python -m h263_tpu.testing.fuzz [seed] [n]`
runs a long one.
"""

from __future__ import annotations

import functools

import numpy as np

from ..bitio import BitReader
from ..parser.frame import parse_frame
from ..parser.picture import decode_picture
from ..types import (
    DecoderOption,
    H263Error,
    PictureOption,
    PictureTypeCode,
)
from .encoder import MBSpec, encode_sorenson_picture, encode_standard_picture

_OPTS = DecoderOption.SORENSON_SPARK_BITSTREAM


def _rand_frame(rng: np.random.Generator, width: int, height: int,
                flavor: str = "sorenson") -> bytes:
    nmb = (-(-width // 16)) * (-(-height // 16))
    ptype = (PictureTypeCode.I_FRAME if rng.random() < 0.4
             else PictureTypeCode.P_FRAME)
    mbs = []
    for _ in range(nmb):
        if ptype is PictureTypeCode.P_FRAME and rng.random() < 0.25:
            mbs.append(MBSpec(kind="uncoded"))
            continue
        blocks = []
        for _ in range(6):
            acs = []
            if rng.random() < 0.5:
                for _ in range(int(rng.integers(0, 6))):
                    lvl = int(rng.integers(1, 40))
                    acs.append((int(rng.integers(0, 8)),
                                lvl if rng.random() < 0.5 else -lvl))
            blocks.append(acs)
        if ptype is PictureTypeCode.I_FRAME:
            dc = int(rng.integers(1, 255)) * 8 % 2048 or 8
            mbs.append(MBSpec(kind="intra", intradc=[dc] * 6, blocks=blocks))
        elif rng.random() < 0.2:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
                   for _ in range(4)]
            mbs.append(MBSpec(kind="inter4v", mvd=mvd, blocks=blocks))
        else:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))]
            mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks))
    if flavor == "standard":
        return encode_standard_picture(
            width, height, ptype, mbs,
            quantizer=int(rng.integers(1, 32)),
            temporal_reference=int(rng.integers(0, 256)),
            umv=rng.random() < 0.5)
    return encode_sorenson_picture(
        width, height, ptype, mbs,
        quantizer=int(rng.integers(1, 32)),
        temporal_reference=int(rng.integers(0, 256)),
        version=1 if rng.random() < 0.5 else 0)


def _mutate(rng: np.random.Generator, base: bytes,
            other_frame) -> bytes:
    mut = bytearray(base)
    op = rng.random()
    if op < 0.4 and len(mut) > 6:  # byte flip past the start code
        j = int(rng.integers(4, len(mut)))
        mut[j] ^= int(rng.integers(1, 256))
    elif op < 0.7:  # truncate (legal EOF tail-fill or mid-symbol EOF)
        mut = mut[: int(rng.integers(4, len(mut) + 1))]
    elif op < 0.85 and len(mut) > 8:  # splice another frame's tail on
        other = other_frame()
        j = int(rng.integers(4, len(mut)))
        mut = mut[:j] + other[int(rng.integers(0, min(8, len(other)))):]
    else:  # garbage tail
        mut = mut + bytes(rng.integers(0, 256,
                                       size=int(rng.integers(1, 32)),
                                       dtype=np.uint8))
    return bytes(mut)


def _rand_umv_case(rng: np.random.Generator, width: int, height: int):
    """MB-layer-only bitstream + synthetic PLUSPTYPE picture exercising the
    UMV table-D.3 path (read_umv / read_umv_fast) with both UNLIMITED and
    EXTENDED motion-vector ranges."""
    from ..types import MotionVectorRange, Picture, SourceFormat
    from .encoder import BitWriter, encode_macroblock

    nmb = (-(-width // 16)) * (-(-height // 16))
    ptype = (PictureTypeCode.I_FRAME if rng.random() < 0.2
             else PictureTypeCode.P_FRAME)

    def mv():
        if rng.random() < 0.3:  # large magnitudes stress the D.3 mantissa
            return int(rng.integers(-700, 701))
        return int(rng.integers(-31, 32))

    w = BitWriter()
    for _ in range(nmb):
        if ptype is PictureTypeCode.P_FRAME and rng.random() < 0.25:
            mbs = MBSpec(kind="uncoded")
        elif ptype is PictureTypeCode.I_FRAME:
            mbs = MBSpec(kind="intra", intradc=[800] * 6)
        else:
            nmv = 4 if rng.random() < 0.25 else 1
            kind = "inter4v" if nmv == 4 else "inter"
            mbs = MBSpec(kind=kind, mvd=[(mv(), mv()) for _ in range(nmv)],
                         blocks=[[(0, int(rng.integers(1, 9)))],
                                 [], [], [], [], []])
        encode_macroblock(w, mbs, ptype, None, umv_d3=True)
    pic = Picture(
        version=None,
        temporal_reference=0,
        format=SourceFormat.extended(width, height),
        options=PictureOption.UNRESTRICTED_MOTION_VECTORS,
        has_plusptype=True,
        has_opptype=True,
        picture_type=ptype,
        quantizer=int(rng.integers(1, 32)),
        motion_vector_range=(MotionVectorRange.EXTENDED
                             if rng.random() < 0.5
                             else MotionVectorRange.UNLIMITED),
    )
    return w.to_bytes(), pic


def _outcome_python(buf: bytes, width: int, height: int, opts, running,
                    pic=None):
    r = BitReader(buf)
    if pic is None:
        pic = decode_picture(r, opts, None)
    return parse_frame(r, pic, opts, running, width, height)


def _outcome_native(buf: bytes, width: int, height: int, opts, running,
                    pic=None):
    from ..native.bindings import parse_frame_native

    r = BitReader(buf)
    if pic is None:
        pic = decode_picture(r, opts, None)
    fd, _ = parse_frame_native(buf, r.pos, pic, opts, running,
                               width, height)
    return fd


_TENSORS = ("coeffs_y", "class_y", "coeffs_cb", "class_cb",
            "coeffs_cr", "class_cr", "mvs", "inter")


def _agree(buf: bytes, width: int, height: int, opts, running,
           pic=None) -> tuple[bool, str]:
    try:
        a, ea = _outcome_python(buf, width, height, opts, running, pic), None
    except H263Error as e:
        a, ea = None, type(e).__name__
    try:
        b, eb = _outcome_native(buf, width, height, opts, running, pic), None
    except H263Error as e:
        b, eb = None, type(e).__name__
    if (a is None) != (b is None):
        return False, f"python={ea or 'ok'} native={eb or 'ok'}"
    if a is None:
        return (ea == eb), f"python={ea} native={eb}"
    for name in _TENSORS:
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            return False, f"tensor {name} differs"
    return True, ""


def _rand_d24_frame(rng: np.random.Generator, width: int, height: int) -> bytes:
    """Frame generator biased at the delta24 transport's edge cases:

    * long empty stretches between coefficients — a gap > 4095 in ordinal
      (mb, block, zigzag) space needs ~11 consecutive coefficient-free
      macroblocks and forces advance-only escape entries
      (entropy.cpp emit(): gap > 4095 loop);
    * zigzag-overflow blocks (run sums past position 63) — the whole block
      is discarded and the emitter REWINDS the pack cursor
      (decode_block `discard` path), while later blocks still emit;
    * both Sorenson escape widths (version 0/1), INTRADC, INTER4V.
    """
    nmb = (-(-width // 16)) * (-(-height // 16))
    ptype = (PictureTypeCode.I_FRAME if rng.random() < 0.25
             else PictureTypeCode.P_FRAME)
    sparse = rng.random() < 0.6  # sparse frames hit the gap>4095 escapes
    mbs = []
    for _ in range(nmb):
        if ptype is PictureTypeCode.P_FRAME and rng.random() < (
                0.9 if sparse else 0.25):
            mbs.append(MBSpec(kind="uncoded"))
            continue
        blocks = []
        for _ in range(6):
            acs = []
            roll = rng.random()
            if roll < (0.08 if sparse else 0.4):
                for _ in range(int(rng.integers(1, 5))):
                    lvl = int(rng.integers(1, 40))
                    acs.append((int(rng.integers(0, 10)),
                                lvl if rng.random() < 0.5 else -lvl))
            elif roll < (0.12 if sparse else 0.5):
                # zigzag overflow: runs sum past 63 -> block discard+rewind
                acs = [(30, 5), (30, -7), (30, 9)]
            blocks.append(acs)
        if ptype is PictureTypeCode.I_FRAME:
            dc = int(rng.integers(1, 255)) * 8 % 2048 or 8
            mbs.append(MBSpec(kind="intra", intradc=[dc] * 6, blocks=blocks))
        elif rng.random() < 0.15:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))
                   for _ in range(4)]
            mbs.append(MBSpec(kind="inter4v", mvd=mvd, blocks=blocks))
        else:
            mvd = [(int(rng.integers(-8, 9)), int(rng.integers(-8, 9)))]
            mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks))
    return encode_sorenson_picture(
        width, height, ptype, mbs,
        quantizer=int(rng.integers(1, 32)),
        temporal_reference=int(rng.integers(0, 256)),
        version=1 if rng.random() < 0.5 else 0)


@functools.lru_cache(maxsize=8)
def _d24_decode_fn(mbh: int, mbw: int):
    import jax

    from ..decoder.reconstruct import d24_to_posval

    return jax.jit(functools.partial(d24_to_posval, mbh=mbh, mbw=mbw))


def _agree_d24(buf: bytes, width: int, height: int) -> tuple[bool, str]:
    """Round-trip the d24 transport end-to-end against the Python dense
    front-end: native emit (entropy.cpp F_PACK_DELTA24) -> the production
    device decode (reconstruct.d24_to_posval, jit on CPU) -> scatter-add
    -> must equal the dense coefficient tensors exactly; mvs/inter too.
    Parse failures must agree on the error class."""
    from ..native.bindings import PackOverflow, parse_frame_native_packed

    mb_w = -(-width // 16)
    mb_h = -(-height // 16)
    nmb = mb_w * mb_h

    try:
        a, ea = _outcome_python(buf, width, height, _OPTS,
                                PictureOption.NONE), None
    except H263Error as e:
        a, ea = None, type(e).__name__

    cap = 12 * nmb + 256
    pack = np.zeros(3 * cap, dtype=np.uint8)
    mvs = np.zeros((mb_h, mb_w, 4, 2), dtype=np.int16)
    mvs_slim = np.zeros((mb_h, mb_w, 2), dtype=np.int16)
    inter = np.ones((mb_h, mb_w), dtype=np.uint8)
    scratch = np.zeros((nmb, 4, 2), dtype=np.int16)
    try:
        r = BitReader(buf)
        pic = decode_picture(r, _OPTS, None)
        count, _ = parse_frame_native_packed(
            buf, r.pos, pic, _OPTS, PictureOption.NONE, width, height,
            pack, mvs, inter, scratch, transport="d24", mvs_slim=mvs_slim)
        # The caller owns tail padding (bindings docstring): entries past
        # `count` may be stale leftovers of discard-rewound blocks or
        # EOF-rolled-back macroblocks.  The production paths pad in
        # h263_sorenson_decode_frame / the fused batch's bucket padding /
        # parse_batch_packed_standard; mirror that here.
        pack[3 * count:] = 0
        eb = None
    except PackOverflow:
        # Production falls back to the dense transport; not a mismatch.
        return True, "overflow-skip"
    except H263Error as e:
        eb = type(e).__name__
    if (a is None) != (eb is not None):
        return False, f"python={ea or 'ok'} d24={eb or 'ok'}"
    if a is None:
        return (ea == eb), f"python={ea} d24={eb}"

    pos, val = _d24_decode_fn(mb_h, mb_w)(pack[None, :])
    pos = np.asarray(pos)[0].astype(np.int64)
    val = np.asarray(val)[0].astype(np.int32)
    dense = np.zeros(6 * nmb * 64 + 1, dtype=np.int32)
    np.add.at(dense, np.minimum(pos, 6 * nmb * 64), val)
    dense = dense[:-1]

    want = np.concatenate([
        a.coeffs_y.reshape(4 * nmb, 64),
        a.coeffs_cb.reshape(nmb, 64),
        a.coeffs_cr.reshape(nmb, 64)]).reshape(-1).astype(np.int32)
    if not np.array_equal(dense, want):
        bad = int(np.flatnonzero(dense != want)[0])
        return False, (f"coefficient {bad}: d24 {dense[bad]} "
                       f"vs dense {want[bad]} (count={count})")
    if not np.array_equal(mvs, a.mvs):
        return False, "mvs differ"
    if not np.array_equal(inter.astype(bool), a.inter):
        return False, "inter differs"
    if not np.array_equal(mvs_slim, a.mvs[:, :, 0, :]):
        return False, "mvs_slim differs"
    return True, ""


def _rand_fused_gop(rng: np.random.Generator, width: int, height: int,
                    n_frames: int) -> list[bytes]:
    """One stream's GOP biased at the fused transport's state machinery:
    random Sorenson versions (both escape widths), random quantizers +
    DQUANT walks, sparse/dense frames (bucket-ladder churn), INTER4V at
    random steps (the sticky slim->full MV row flip), DisposableP frames
    (all-uncoded by the reference's macroblock.rs:461-464 quirk), and
    uncoded-heavy tails."""
    nmb = (-(-width // 16)) * (-(-height // 16))
    frames = []
    for t in range(n_frames):
        quant = int(rng.integers(1, 32))
        version = 1 if rng.random() < 0.5 else 0
        if t and rng.random() < 0.1:
            frames.append(encode_sorenson_picture(
                width, height, PictureTypeCode.DISPOSABLE_P_FRAME,
                [MBSpec(kind="uncoded")] * nmb, quantizer=quant,
                temporal_reference=t & 0xFF, version=version, pad_bit=1))
            continue
        ptype = (PictureTypeCode.I_FRAME if t == 0 or rng.random() < 0.15
                 else PictureTypeCode.P_FRAME)
        dense = rng.random()  # per-frame density -> transfer-bucket churn
        fourv_p = 0.3 if rng.random() < 0.3 else 0.0
        mbs = []
        for _ in range(nmb):
            if ptype is PictureTypeCode.P_FRAME and rng.random() < (
                    0.8 if dense < 0.4 else 0.25):
                mbs.append(MBSpec(kind="uncoded"))
                continue
            blocks = []
            for _ in range(6):
                acs = []
                if rng.random() < (0.15 if dense < 0.4 else 0.55):
                    for _ in range(int(rng.integers(1, 5))):
                        lvl = int(rng.integers(1, 40))
                        acs.append((int(rng.integers(0, 8)),
                                    lvl if rng.random() < 0.5 else -lvl))
                blocks.append(acs)
            dq = int(rng.integers(-2, 3)) if rng.random() < 0.2 else 0
            if ptype is PictureTypeCode.I_FRAME:
                dc = int(rng.integers(1, 255)) * 8 % 2048 or 8
                mbs.append(MBSpec(kind="intra", intradc=[dc] * 6,
                                  blocks=blocks, dquant=dq))
            elif rng.random() < fourv_p:
                mvd = [(int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
                       for _ in range(4)]
                mbs.append(MBSpec(kind="inter4v", mvd=mvd, blocks=blocks,
                                  dquant=dq))
            else:
                mvd = [(int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))]
                mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks,
                                  dquant=dq))
        frames.append(encode_sorenson_picture(
            width, height, ptype, mbs, quantizer=quant,
            temporal_reference=t & 0xFF, version=version))
    return frames


def _fused_scenario(rng: np.random.Generator, width: int, height: int,
                    report) -> tuple[int, int]:
    """One randomized multi-step scenario: the fused single-leaf batch
    driver vs the legacy three-leaf d24 transport, bit-identical planes
    per step (or the same error class, after which stepping CONTINUES —
    parse failures must be atomic in both paths).  Axes beyond the fixed
    tests in tests/test_fused_transport.py: random version/quant/density
    churn, truncations and byte flips mid-GOP, absent-slot masks, flip
    steps where only some streams vary, DisposableP frames."""
    from . import build_batched_decoder

    S = int(rng.integers(2, 5))
    T = int(rng.integers(6, 11))
    gops = [_rand_fused_gop(rng, width, height, T) for _ in range(S)]
    for s in range(S):
        for t in range(T):
            r = rng.random()
            buf = gops[s][t]
            if r < 0.08 and len(buf) > 6:  # truncate: tail-fill or EOF error
                gops[s][t] = buf[: int(rng.integers(4, len(buf) + 1))]
            elif r < 0.13 and len(buf) > 6:  # byte flip past the start code
                mut = bytearray(buf)
                mut[int(rng.integers(4, len(mut)))] ^= int(
                    rng.integers(1, 256))
                gops[s][t] = bytes(mut)
    masks = [([bool(x) for x in rng.random(S) < 0.7]
              if rng.random() < 0.25 else None) for _ in range(T)]

    da = build_batched_decoder(S, width, height, _OPTS, fused=True)
    db = build_batched_decoder(S, width, height, _OPTS, fused=False)
    cases = fails = 0
    for t in range(T):
        bufs = [gops[s][t] for s in range(S)]
        outs = []
        for dec in (da, db):
            try:
                y, cb, cr = dec.decode_step(bufs, mask=masks[t])
                outs.append((np.asarray(y), np.asarray(cb), np.asarray(cr)))
            except H263Error as e:
                outs.append(type(e).__name__)
        cases += 1
        a, b = outs
        if isinstance(a, str) or isinstance(b, str):
            if a != b:
                fails += 1
                report(f"step[{t}]", f"fused={a if isinstance(a, str) else 'ok'}"
                                     f" legacy={b if isinstance(b, str) else 'ok'}")
                break
            continue  # agreed error; both atomic — keep stepping
        for name, x, y in zip(("y", "cb", "cr"), a, b):
            if not np.array_equal(x, y):
                fails += 1
                bad = np.argwhere(x != y)[0]
                report(f"step[{t}]", f"plane {name} differs at {bad.tolist()}"
                                     f" (S={S} {width}x{height})")
                return cases, fails
    return cases, fails


@functools.lru_cache(maxsize=8)
def _device_parse_fn(mbh: int, mbw: int, tape_len: int,
                     width: int = None, height: int = None):
    import jax

    from ..parser import device_frontend as df

    def run(data_u8, start_bit, nbits, quant0, ptype, v1):
        words = df.payload_words(data_u8)
        tapes = df.parse_frames_device(
            words, start_bit, nbits, quant0, ptype, v1,
            mbh=mbh, mbw=mbw, tape_len=tape_len,
            width=width, height=height)
        return df.assemble(tapes, mbh=mbh, mbw=mbw) + (tapes["status"],)

    return jax.jit(run)


def _agree_device(buf: bytes, width: int, height: int,
                  opts=_OPTS, running=None, pic=None) -> tuple[bool, str]:
    """Differential: the device entropy automaton vs the Python host
    parser — dense coefficients / MVs / INTER must match exactly on
    success, and error CLASSES must match on failure
    (df.status_error_class).  Cases whose picture header fails to parse
    are out of scope (headers are host work in the device path).
    Standard payloads carrying embedded start codes are IN scope since
    round 4 late — the GOB-resync scan runs in-automaton.

    `running`: carried running options (the production gate/dispatch uses
    carry_forward_options, never pic.options alone).  `pic`: header-LESS
    mode — buf starts at the MB layer and `pic` is the synthetic header
    (the UMV flavors)."""
    from ..parser import device_frontend as df
    from ..types import carry_forward_options

    headerless = pic is not None
    try:
        r = BitReader(buf)
        if not headerless:
            pic = decode_picture(r, opts, None)
            if pic is None:
                return True, ""
        run_opts = carry_forward_options(
            pic, running if running is not None else PictureOption.NONE)
        if not df.supports(pic, run_opts):
            return True, ""
    except H263Error:
        return True, ""  # host-side header reject; device never dispatches

    mb_w, mb_h = -(-width // 16), -(-height // 16)
    nmb = mb_w * mb_h
    # NB: _outcome_python's `pic` parameter is for header-LESS buffers (the
    # UMV flavors); with a header in buf, let it re-decode it and advance
    # its own reader past it.
    try:
        a, ea = _outcome_python(buf, width, height, opts, run_opts,
                                pic if headerless else None), None
    except H263Error as e:
        a, ea = None, type(e)

    BUCKET = 4096
    if len(buf) > BUCKET:
        return True, ""  # outside the fuzz transfer bucket
    data_u8, nbits = df.pack_payloads([buf], BUCKET)
    fn = _device_parse_fn(mb_h, mb_w, 96 * nmb, width, height)

    dense, mvs, inter, ok, status = fn(
        data_u8, np.array([r.pos], np.int32), nbits,
        np.array([pic.quantizer], np.int32),
        np.array([df.encode_ptype(pic, run_opts)], np.int32),
        np.array([1 if pic.version == 1 else 0], np.int32))
    st = int(np.asarray(status)[0])

    if st == df.ST_TAPE_OVERFLOW:
        # Documented fallback (production re-decodes on host), not a
        # divergence — mirrors _agree_d24's PackOverflow skip.
        return True, "overflow-skip"
    if a is None:
        cls = df.status_error_class(st)
        return (cls is ea), f"python={ea.__name__} device_status={st}"
    if st != 0:
        return False, f"python=ok device_status={st}"
    dense_host = np.concatenate([
        a.coeffs_y.reshape(4 * nmb, 64),
        a.coeffs_cb.reshape(nmb, 64),
        a.coeffs_cr.reshape(nmb, 64)], axis=0)
    if not np.array_equal(np.asarray(dense)[0], dense_host):
        return False, "dense coefficients differ"
    if not np.array_equal(np.asarray(mvs)[0], a.mvs):
        return False, "mvs differ"
    if not np.array_equal(np.asarray(inter)[0], a.inter):
        return False, "inter differs"
    return True, ""


def run_campaign(seed: int = 0, n_base: int = 25, width: int = 96,
                 height: int = 80, mutations_per_base: int = 10,
                 on_fail=None, flavor: str = "sorenson") -> tuple[int, int]:
    """Run a differential campaign; returns (total_cases, mismatches).

    Each base frame is checked as-is plus `mutations_per_base` mutants.
    `on_fail(tag, detail)` is called per mismatch (default: print).

    flavor "sorenson" (default) covers both Sorenson escape widths and
    DisposableP; "standard" uses plain-PTYPE pictures (8-bit escapes) at a
    CIF-family size and randomly injects carried UNRESTRICTED_MOTION_VECTORS
    running options (plain-PTYPE headers alone never activate UMV — their
    OPPTYPE-class bits are discarded by the carry-forward rule, so the
    wraparound path is reachable only via carried state).  "d24"
    round-trips the delta24 transport end-to-end (native emit -> the
    production device decode -> scatter) against the Python dense
    front-end, biased at the gap>4095 escape and discard-rewind edges
    (VERDICT r2 #7).  "fused" runs multi-step batch scenarios through the
    round-3 fused single-leaf transport vs the legacy three-leaf path
    (sticky MV-row flip, bucket churn, masks, mid-GOP corruption; n_base
    counts scenarios).
    """
    from ..native import ensure_built

    if not ensure_built():
        raise RuntimeError("native front-end unavailable")
    if flavor == "fused":
        # Multi-step scenarios through the production fused batch driver
        # vs the legacy three-leaf transport; `n_base` counts scenarios
        # (each is 6-10 decode_steps of 2-4 streams).  Small dims keep the
        # per-scenario jit compiles cheap on CPU.
        rng = np.random.default_rng(seed)
        report = on_fail or (lambda tag, why: print(f"MISMATCH {tag}: {why}"))
        dims = [(48, 48), (64, 48), (96, 64), (80, 80)]
        total = fails = 0
        for i in range(n_base):
            w, h = dims[int(rng.integers(0, len(dims)))]
            c, f = _fused_scenario(
                rng, w, h,
                lambda tag, why, _i=i: report(f"scenario[{_i}].{tag}", why))
            total += c
            fails += f
        return total, fails
    if flavor in ("d24", "device", "device_std", "device_umv"):
        # "d24"/"device" run the _rand_d24_frame generator (rich in
        # discard / escape / sparsity edges); "device" checks the device
        # entropy automaton against the Python parser (tensors + error
        # classes), "device_std" does the same over STANDARD plain-PTYPE
        # pictures at CIF-family dims (soft MCBPC/CBPY semantics; half
        # the bases run under CARRIED UNRESTRICTED_MOTION_VECTORS — the
        # v1 range rule is reachable only via carried state; 40% of the
        # bases carry a spliced GOB-header-shaped run, driving the
        # in-automaton resync scan).
        # "device_umv" drives the automaton's table-D.3 MVD decode:
        # PLUSPTYPE UMV pictures (EXTENDED and UNLIMITED ranges, INTER4V,
        # large mantissas) vs the Python parser.
        # Each generator yields (buf, pic_or_None, running); mutants of a
        # base keep the base's synthetic header/running context.
        if flavor == "device_std":
            if (width, height) == (96, 80):
                width, height = 128, 96

            def gen(rng):
                run = (PictureOption.UNRESTRICTED_MOTION_VECTORS
                       if rng.random() < 0.5 else PictureOption.NONE)
                if rng.random() < 0.25:
                    # r5: MODIFIED_QUANTIZATION runs in-automaton — the
                    # first coded MB must fail UnimplementedDecoding
                    # (macroblock.rs:497-498) while all-uncoded pictures
                    # decode; differentially pinned here under carried MQ.
                    run |= PictureOption.MODIFIED_QUANTIZATION
                buf = _rand_frame(rng, width, height, flavor="standard")
                if rng.random() < 0.4:
                    # Splice a GOB-header-shaped run mid-payload so the
                    # in-automaton resync scan (soft MB error -> start-code
                    # peek -> GN routes tail-fill vs UnimplementedDecoding)
                    # is differentially exercised.  GN 0/15 = picture
                    # boundary; 1..14 = real GOB header (frame fails).
                    gn = int(rng.choice([0, 15, 1, 5, 14]))
                    code = bytes([0, 0, 0x80 | (gn << 2)
                                  | int(rng.integers(0, 4))])
                    if rng.random() < 0.3:
                        code = b"\x00" + code  # stuffing-heavy run
                    at = int(rng.integers(6, max(7, len(buf))))
                    buf = buf[:at] + code + buf[at:]
                return buf, None, run

            def agree(b, w, h, pic, run):
                return _agree_device(b, w, h, DecoderOption.NONE,
                                     running=run)
        elif flavor == "device_umv":
            def gen(rng):
                buf, pic = _rand_umv_case(rng, width, height)
                return buf, pic, PictureOption.UNRESTRICTED_MOTION_VECTORS

            def agree(b, w, h, pic, run):
                return _agree_device(b, w, h, DecoderOption.NONE,
                                     running=run, pic=pic)
        else:
            def gen(rng):
                return _rand_d24_frame(rng, width, height), None, None

            _agree0 = _agree_d24 if flavor == "d24" else _agree_device

            def agree(b, w, h, pic, run):
                return _agree0(b, w, h)
        rng = np.random.default_rng(seed)
        report = on_fail or (lambda tag, why: print(f"MISMATCH {tag}: {why}"))
        total = fails = 0
        for i in range(n_base):
            base, pic_i, run_i = gen(rng)
            ok, why = agree(base, width, height, pic_i, run_i)
            total += 1
            if not ok:
                fails += 1
                report(f"base[{i}]", why)
            for m in range(mutations_per_base):
                mut = _mutate(rng, base, lambda: gen(rng)[0])
                ok, why = agree(mut, width, height, pic_i, run_i)
                total += 1
                if not ok:
                    fails += 1
                    report(f"mut[{i}.{m}]", why)
        return total, fails
    if flavor == "standard":
        opts = DecoderOption.NONE
        cif_family = {(128, 96), (176, 144), (352, 288), (704, 576),
                      (1408, 1152)}
        if (width, height) == (96, 80):  # the generic default: pick SUB_QCIF
            width, height = 128, 96
        elif (width, height) not in cif_family:
            raise ValueError(
                f"standard flavor needs CIF-family dims, got {(width, height)}")
    elif flavor == "umv":
        opts = DecoderOption.NONE
    else:
        opts = _OPTS
    rng = np.random.default_rng(seed)
    report = on_fail or (lambda tag, why: print(f"MISMATCH {tag}: {why}"))
    total = fails = 0
    for i in range(n_base):
        if flavor == "umv":
            running = PictureOption.UNRESTRICTED_MOTION_VECTORS
            base, pic = _rand_umv_case(rng, width, height)
            make = lambda: _rand_umv_case(rng, width, height)[0]  # noqa: E731
        else:
            running = (PictureOption.UNRESTRICTED_MOTION_VECTORS
                       if flavor == "standard" and rng.random() < 0.5
                       else PictureOption.NONE)
            base, pic = _rand_frame(rng, width, height, flavor), None
            make = lambda: _rand_frame(rng, width, height, flavor)  # noqa: E731
        ok, why = _agree(base, width, height, opts, running, pic)
        total += 1
        if not ok:
            fails += 1
            report(f"base[{i}]", why)
        for m in range(mutations_per_base):
            mut = _mutate(rng, base, make)
            ok, why = _agree(mut, width, height, opts, running, pic)
            total += 1
            if not ok:
                fails += 1
                report(f"mut[{i}.{m}]", why)
    return total, fails


if __name__ == "__main__":  # pragma: no cover
    import sys

    import jax

    # The campaign compiles many small shapes and reads every result
    # back; the CPU backend is the right place for that.
    jax.config.update("jax_platforms", "cpu")

    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 300
    flavor = sys.argv[3] if len(sys.argv) > 3 else "sorenson"
    total, fails = run_campaign(seed=seed, n_base=n, flavor=flavor)
    print(f"fuzz campaign ({flavor}): {total} cases, {fails} mismatches")
    sys.exit(1 if fails else 0)
