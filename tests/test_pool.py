"""Mixed-resolution stream pool."""

import numpy as np

from h263_tpu import DecoderOption, H263Decoder, PictureTypeCode
from h263_tpu.parallel.pool import StreamPool
from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def _frames(seed, w, h, n=3):
    rng = np.random.default_rng(seed)
    nmb = (-(-w // 16)) * (-(-h // 16))
    out = [encode_sorenson_picture(
        w, h, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
         for _ in range(nmb)], temporal_reference=0)]
    for tr in range(1, n):
        out.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, 0)],
                    blocks=[[(0, 3)], [], [], [], [], []])] * nmb,
            temporal_reference=tr))
    return out


def test_pool_mixed_resolutions():
    streams = {
        "cif_a": (352, 288, _frames(1, 352, 288)),
        "cif_b": (352, 288, _frames(2, 352, 288)),
        "qcif": (176, 144, _frames(3, 176, 144)),
        "tiny": (32, 32, _frames(4, 32, 32)),
    }
    pool = StreamPool(SORENSON)
    refs = {}
    for sid, (w, h, frames) in streams.items():
        pool.add_stream(sid, w, h)
        refs[sid] = H263Decoder(SORENSON, backend="numpy")

    for t in range(3):
        out = pool.decode_step({sid: s[2][t] for sid, s in streams.items()})
        for sid, (w, h, frames) in streams.items():
            pic = refs[sid].decode_next_picture(frames[t])
            y, cb, cr = out[sid]
            np.testing.assert_array_equal(y, pic.as_luma(), err_msg=sid)
            np.testing.assert_array_equal(cb, pic.as_chroma_b())
    rgba = pool.present_rgba(deblock=False)
    assert rgba["cif_a"].shape == (288, 352, 4)
    assert rgba["tiny"].shape == (32, 32, 4)


def test_pool_dynamic_join_leave_recycle():
    """Streams join mid-run (slot recycle + bucket growth), leave, and the
    pool's output stays bit-exact vs independent single-stream decoders."""
    pool = StreamPool(SORENSON)
    refs = {}

    def start(sid, seed, w=32, h=32, n=6):
        pool.add_stream(sid, w, h)
        refs[sid] = (H263Decoder(SORENSON, backend="numpy"),
                     _frames(seed, w, h, n=n))

    def check(out, sid, t):
        dec, frames = refs[sid]
        pic = dec.decode_next_picture(frames[t])
        y, cb, cr = out[sid]
        np.testing.assert_array_equal(y, pic.as_luma(), err_msg=f"{sid}@{t}")
        np.testing.assert_array_equal(cr, pic.as_chroma_r(), err_msg=sid)

    start("a", 1)
    start("b", 2)
    out = pool.decode_step({"a": refs["a"][1][0], "b": refs["b"][1][0]})
    check(out, "a", 0); check(out, "b", 0)

    # c joins after the bucket finalized (forces growth: no free slots)
    start("c", 3)
    out = pool.decode_step({"a": refs["a"][1][1], "b": refs["b"][1][1],
                            "c": refs["c"][1][0]})
    check(out, "a", 1); check(out, "b", 1); check(out, "c", 0)

    # b leaves; its slot pads. a and c continue bit-exactly.
    pool.remove_stream("b")
    out = pool.decode_step({"a": refs["a"][1][2], "c": refs["c"][1][1]})
    assert set(out) == {"a", "c"}
    check(out, "a", 2); check(out, "c", 1)

    # d recycles b's slot with fresh state (its I-frame decodes clean)
    start("d", 4)
    out = pool.decode_step({"a": refs["a"][1][3], "c": refs["c"][1][2],
                            "d": refs["d"][1][0]})
    check(out, "a", 3); check(out, "c", 2); check(out, "d", 0)


def test_pool_absent_stream_keeps_state():
    """A registered stream that skips steps resumes bit-exactly: its slot
    pads with skip frames and neither its planes nor its header state move."""
    pool = StreamPool(SORENSON)
    fa = _frames(7, 32, 32, n=4)
    fb = _frames(8, 32, 32, n=4)
    pool.add_stream("a", 32, 32)
    pool.add_stream("b", 32, 32)
    ra = H263Decoder(SORENSON, backend="numpy")
    rb = H263Decoder(SORENSON, backend="numpy")

    pool.decode_step({"a": fa[0], "b": fb[0]})
    ra.decode_next_picture(fa[0]); rb.decode_next_picture(fb[0])

    # b sits out two steps while a decodes
    for t in (1, 2):
        out = pool.decode_step({"a": fa[t]})
        assert set(out) == {"a"}
        pic = ra.decode_next_picture(fa[t])
        np.testing.assert_array_equal(out["a"][0], pic.as_luma())

    # b resumes with ITS OWN frame 1 (P-frame onto its frame-0 reference)
    out = pool.decode_step({"a": fa[3], "b": fb[1]})
    pa = ra.decode_next_picture(fa[3])
    pb = rb.decode_next_picture(fb[1])
    np.testing.assert_array_equal(out["a"][0], pa.as_luma())
    np.testing.assert_array_equal(out["b"][0], pb.as_luma(), err_msg="b resumed")


def test_pool_resolution_switch_rebuckets():
    """A stream switching CIF->QCIF at an I-frame rebuckets transparently
    and matches a single-stream decoder across the switch."""
    pool = StreamPool(SORENSON)
    cif = _frames(11, 48, 32, n=2)       # "CIF" bucket (small dims for speed)
    qcif = _frames(12, 32, 16, n=3)      # post-switch GOP at new dims
    other = _frames(13, 32, 16, n=5)     # a stream already at the new dims
    pool.add_stream("x", 48, 32)
    pool.add_stream("o", 32, 16)
    ref = H263Decoder(SORENSON, backend="numpy")
    refo = H263Decoder(SORENSON, backend="numpy")

    seq = [cif[0], cif[1], qcif[0], qcif[1], qcif[2]]  # switch at t=2
    for t, fx in enumerate(seq):
        out = pool.decode_step({"x": fx, "o": other[t]})
        pic = ref.decode_next_picture(fx)
        po = refo.decode_next_picture(other[t])
        np.testing.assert_array_equal(out["x"][0], pic.as_luma(),
                                      err_msg=f"x@{t}")
        np.testing.assert_array_equal(out["o"][0], po.as_luma())
    assert pool._dims["x"] == (32, 16)
    rgba = pool.present_rgba(deblock=False)
    assert rgba["x"].shape == (16, 32, 4)


def test_pool_resolution_switch_on_pframe_rejected():
    """Dims change on a non-I frame is a per-stream error (no reference
    exists at the new size)."""
    import pytest
    from h263_tpu.types import PictureFormatInvalid

    pool = StreamPool(SORENSON)
    a = _frames(14, 32, 32, n=2)
    b = _frames(15, 48, 48, n=3)
    pool.add_stream("s", 32, 32)
    pool.decode_step({"s": a[0]})
    with pytest.raises(PictureFormatInvalid):
        pool.decode_step({"s": b[1]})  # P-frame at foreign dims


def test_pool_randomized_churn_vs_singles():
    """Long randomized serving schedule — joins, leaves, skipped steps,
    corrupt frames, slot recycling — stays bit-exact against independent
    single-stream decoders, and a corrupt frame fails loudly without
    moving any other stream's state (batch atomicity)."""
    import pytest
    from h263_tpu.types import H263Error

    rng = np.random.default_rng(99)
    pool = StreamPool(SORENSON)
    live = {}     # sid -> (ref decoder, frames, next_t)
    next_id = 0

    def join():
        nonlocal next_id
        sid = f"s{next_id}"
        next_id += 1
        w, h = (32, 32) if rng.random() < 0.7 else (48, 32)
        frames = _frames(int(rng.integers(1, 10_000)), w, h,
                         n=int(rng.integers(4, 9)))
        pool.add_stream(sid, w, h)
        live[sid] = [H263Decoder(SORENSON, backend="numpy"), frames, 0]
        return sid

    for _ in range(3):
        join()

    corrupt_seen = 0
    for step in range(40):
        roll = rng.random()
        if roll < 0.15 and len(live) < 7:
            join()
        elif roll < 0.25 and len(live) > 2:
            sid = sorted(live)[int(rng.integers(0, len(live)))]
            pool.remove_stream(sid)
            del live[sid]

        # pick this step's participants (some streams sit out); streams
        # whose GOP ran out loop back via leave+rejoin
        feed = {}
        for sid, st in list(live.items()):
            dec, frames, t = st
            if t >= len(frames):
                pool.remove_stream(sid)
                del live[sid]
                continue
            if rng.random() < 0.2:
                continue  # sits out this step
            feed[sid] = frames[t]
        if not feed:
            continue

        if corrupt_seen < 3 and rng.random() < 0.15:
            # corrupt one participant's frame body: the step must raise,
            # and NO stream's state may advance (atomicity)
            victim = sorted(feed)[int(rng.integers(0, len(feed)))]
            bad = bytearray(feed[victim])
            if len(bad) > 8:
                bad[int(rng.integers(6, len(bad)))] ^= 0xFF
            bad = bad[: max(5, len(bad) // 3)]  # truncate into the header
            feed2 = dict(feed)
            feed2[victim] = bytes(bad)
            try:
                pool.decode_step(feed2)
            except H263Error:
                corrupt_seen += 1
                continue  # nothing committed; retry cleanly next step
            # Some mutations decode legally (EOF tail-fill) — then the
            # victim's oracle must consume the same bytes.
            live[victim][0].decode_next_picture(bytes(bad))
            live[victim][2] += 1
            for sid in feed:
                if sid != victim:
                    live[sid][0].decode_next_picture(feed[sid])
                    live[sid][2] += 1
            continue

        out = pool.decode_step(feed)
        assert set(out) == set(feed)
        for sid, buf in feed.items():
            dec, frames, t = live[sid]
            pic = dec.decode_next_picture(buf)
            np.testing.assert_array_equal(
                out[sid][0], pic.as_luma(), err_msg=f"{sid} step {step}")
            live[sid][2] += 1
    assert corrupt_seen >= 1, "schedule never exercised a corrupt frame"


def test_pool_steady_state_zero_host_fetches():
    """A steady-state pool step performs ZERO implicit device->host
    fetches — results stay device-resident until indexed, so the serving
    API never synchronises with the device on its own."""
    from h263_tpu.utils import trace

    fa = _frames(31, 64, 48, n=5)
    fb = _frames(32, 32, 32, n=5)
    pool = StreamPool(SORENSON)
    pool.add_stream("a", 64, 48)
    pool.add_stream("b", 32, 32)

    before = trace.get_counters().get("pool_host_fetches", 0)
    results = []
    for t in range(5):
        results.append(pool.decode_step({"a": fa[t], "b": fb[t]}))
    base = trace.get_counters().get("pool_host_fetches", 0)
    assert base == before, "steady-state steps must not fetch"

    # device_planes is fetch-free too.
    y, cb, cr = results[-1].device_planes("a")
    assert y.shape == (48, 64)
    assert trace.get_counters().get("pool_host_fetches", 0) == base

    # Explicit indexing IS the fetch, counted and cached, and matches the
    # scalar reference decoder.
    ref = H263Decoder(SORENSON, backend="numpy")
    for f in fa:
        pic = ref.decode_next_picture(f)
    ya, cba, cra = results[-1]["a"]
    n_fetch = trace.get_counters().get("pool_host_fetches", 0)
    assert n_fetch == base + 1
    results[-1]["a"]  # cached: no second fetch
    assert trace.get_counters().get("pool_host_fetches", 0) == n_fetch
    np.testing.assert_array_equal(ya, pic.as_luma())
    np.testing.assert_array_equal(cba, pic.as_chroma_b())
    np.testing.assert_array_equal(cra, pic.as_chroma_r())


def test_pool_result_views_are_reiterable():
    """items()/values() are materialized Mapping-style views: iterating a
    result twice (log pass then process pass) must not silently yield
    nothing the second time."""
    fa = _frames(41, 32, 32, n=2)
    pool = StreamPool(SORENSON)
    pool.add_stream("a", 32, 32)
    res = pool.decode_step({"a": fa[0]})
    first = list(res.items())
    second = list(res.items())
    assert len(first) == len(second) == 1
    assert [sid for sid, _ in second] == ["a"]
    assert len(list(res.values())) == len(list(res.values())) == 1


class TestDeviceFrontendPool:
    """The pool lifecycle over DeviceFrontendDecoder buckets
    (frontend="device"): same join/leave/recycle/growth/absent semantics,
    decode bit-exact vs single-stream oracles, plus the device-only
    tape-overflow repair surfaced per stream id."""

    def test_mixed_resolutions_churn_bitexact(self):
        pool = StreamPool(SORENSON, frontend="device")
        refs = {}

        def start(sid, seed, w, h, n=4):
            pool.add_stream(sid, w, h)
            refs[sid] = [H263Decoder(SORENSON, backend="numpy"),
                         _frames(seed, w, h, n=n), 0]

        def check(out, sid):
            dec, frames, t = refs[sid]
            pic = dec.decode_next_picture(frames[t])
            refs[sid][2] += 1
            y, cb, cr = out[sid]
            np.testing.assert_array_equal(y, pic.as_luma(),
                                          err_msg=f"{sid}@{t}")
            np.testing.assert_array_equal(cb, pic.as_chroma_b())
            np.testing.assert_array_equal(cr, pic.as_chroma_r())

        start("a", 1, 32, 32)
        start("b", 2, 32, 32)
        start("q", 3, 48, 32)
        feed = lambda sids: pool.decode_step(
            {sid: refs[sid][1][refs[sid][2]] for sid in sids})
        out = feed(["a", "b", "q"])
        for sid in ("a", "b", "q"):
            check(out, sid)
        # "b" sits out (slot masks; planes/state persist).
        out = feed(["a", "q"])
        check(out, "a"); check(out, "q")
        assert "b" not in out
        # join forces 32x32 bucket growth (2 -> 4 slots); leave + rejoin
        # recycles.
        start("c", 4, 32, 32)
        out = feed(["a", "b", "c", "q"])
        for sid in ("a", "b", "c", "q"):
            check(out, sid)
        pool.remove_stream("b")
        del refs["b"]
        start("d", 5, 32, 32)
        out = feed(["a", "c", "d", "q"])
        for sid in ("a", "c", "d", "q"):
            check(out, sid)
        rgba = pool.present_rgba(deblock=False)
        assert rgba["q"].shape == (32, 48, 4)

    def test_overflow_repair_by_stream_id(self):
        # A 8-slot tape can't fit these frames: every decoded lane
        # overflows; resolve_overflows() repairs them host-side and
        # reports the stream ids.
        pool = StreamPool(SORENSON, frontend="device", tape_len=8)
        refs = {}
        for sid, seed in (("x", 11), ("y", 12)):
            pool.add_stream(sid, 32, 32)
            refs[sid] = (H263Decoder(SORENSON, backend="numpy"),
                         _frames(seed, 32, 32, n=2))
        results = []
        for t in range(2):
            res = pool.decode_step({sid: refs[sid][1][t] for sid in refs})
            repaired = sorted(pool.resolve_overflows(res))
            assert repaired == ["x", "y"]
            results.append(res)
        for sid, (dec, frames) in refs.items():
            pics = [dec.decode_next_picture(f) for f in frames]
            bucket = pool._buckets[(32, 32)]
            slot = bucket.slots[sid]
            np.testing.assert_array_equal(
                np.asarray(bucket.dec.ref_y[slot]), pics[-1].as_luma(),
                err_msg=sid)
            # Passing the step result re-points its entries at the fixed
            # planes (the returned arrays themselves are immutable).
            for t, res in enumerate(results):
                y, cb, cr = res[sid]
                np.testing.assert_array_equal(y, pics[t].as_luma(),
                                              err_msg=f"{sid} result@{t}")

    def test_overflow_edge_cases_never_stepped_and_growth(self):
        """resolve_overflows is a no-op on a bucket that was finalized but
        never decoded (regression: fetch_status on last_status=None), and
        an overflow flagged right before a bucket growth stays repairable
        (growth migrates last_status)."""
        pool = StreamPool(SORENSON, frontend="device", tape_len=8)
        pool.add_stream("a", 32, 32)
        pool.add_stream("b", 48, 32)
        fa = _frames(21, 32, 32, n=2)
        # b's bucket finalizes but decodes nothing this step.
        res = pool.decode_step({"a": fa[0]})
        assert sorted(pool.resolve_overflows(res)) == ["a"]
        # Overflow on the next step, then grow a's bucket BEFORE repair
        # (the 32x32 bucket has one slot, so this join doubles it).
        res = pool.decode_step({"a": fa[1]})
        pool.add_stream("c", 32, 32)
        assert pool._buckets[(32, 32)].dec.n == 2
        assert sorted(pool.resolve_overflows(res)) == ["a"]
        oracle = H263Decoder(SORENSON, backend="numpy")
        pics = [oracle.decode_next_picture(f) for f in fa]
        bucket = pool._buckets[(32, 32)]
        np.testing.assert_array_equal(
            np.asarray(bucket.dec.ref_y[bucket.slots["a"]]),
            pics[-1].as_luma())

    def test_device_pool_standard_streams(self):
        """A standard-H.263 device-frontend pool decodes bit-exact vs the
        single-stream oracle (incl. a skipped step)."""
        from h263_tpu.testing.encoder import encode_standard_picture

        def std_frames(seed, n=3):
            rng = np.random.default_rng(seed)
            nmb = 8 * 6
            out = [encode_standard_picture(
                128, 96, PictureTypeCode.I_FRAME,
                [MBSpec(kind="intra",
                        intradc=[int(rng.integers(1, 128)) * 8] * 6)
                 for _ in range(nmb)])]
            for tr in range(1, n):
                out.append(encode_standard_picture(
                    128, 96, PictureTypeCode.P_FRAME,
                    [MBSpec(kind="inter", mvd=[(2, 0)],
                            blocks=[[(0, 3)], [], [], [], [], []])] * nmb,
                    temporal_reference=tr))
            return out

        pool = StreamPool(DecoderOption.NONE, frontend="device")
        refs = {}
        for sid, seed in (("a", 31), ("b", 32)):
            pool.add_stream(sid, 128, 96)
            refs[sid] = (H263Decoder(DecoderOption.NONE, backend="numpy"),
                         std_frames(seed))
        cursor = {"a": 0, "b": 0}
        for t in range(3):
            feed = {sid: refs[sid][1][cursor[sid]] for sid in refs
                    if not (t == 1 and sid == "b")}
            out = pool.decode_step(feed)
            for sid in feed:
                dec, frames = refs[sid]
                pic = dec.decode_next_picture(frames[cursor[sid]])
                cursor[sid] += 1
                y, cb, cr = out[sid]
                np.testing.assert_array_equal(y, pic.as_luma(),
                                              err_msg=f"{sid}@{t}")


def test_pool_rebucket_dims_bounded():
    """A header sniffing as an absurd resolution must not size a bucket
    (planes + compiled program come from untrusted bits): per-stream
    PictureFormatInvalid, pool and stream state intact."""
    import pytest
    from h263_tpu.testing.encoder import BitWriter
    from h263_tpu.types import PictureFormatInvalid

    pool = StreamPool(SORENSON)
    a = _frames(40, 32, 32, n=3)
    pool.add_stream("s", 32, 32)
    pool.decode_step({"s": a[0]})

    # Sorenson v1 header claiming custom 16-bit dims 65535x65535, I-frame.
    w = BitWriter()
    w.write_bits(1, 17)       # PSC
    w.write_bits(1, 5)        # version
    w.write_bits(3, 8)        # TR
    w.write_bits(1, 3)        # fmt = custom 16-bit
    w.write_bits(65535, 16)   # width
    w.write_bits(65535, 16)   # height
    w.write_bits(0, 2)        # ptype I
    w.write_bits(0, 1)        # deblocker
    w.write_bits(9, 5)        # quant
    w.write_bits(0, 1)        # PEI
    with pytest.raises(PictureFormatInvalid, match="bound"):
        pool.decode_step({"s": w.to_bytes()})
    assert (65535, 65535) not in pool._buckets
    assert pool._dims["s"] == (32, 32)
    # The stream continues from its preserved state.
    ref = H263Decoder(SORENSON, backend="numpy")
    for f in a[:1]:
        ref.decode_next_picture(f)
    out = pool.decode_step({"s": a[1]})
    np.testing.assert_array_equal(out["s"][0],
                                  ref.decode_next_picture(a[1]).as_luma())


def test_pool_rebucket_garbage_body_keeps_old_state():
    """A frame whose header sniffs as a valid I-frame at new dims but
    whose MB layer is garbage must NOT destroy the stream's old state
    (whole-picture transaction, state.rs:119-137)."""
    import pytest
    from h263_tpu.types import PictureFormatInvalid

    pool = StreamPool(SORENSON)
    a = _frames(41, 32, 32, n=3)
    b = _frames(42, 48, 48, n=1)
    pool.add_stream("s", 32, 32)
    pool.decode_step({"s": a[0]})

    bad = b[0][:10] + b"\xff" * 4  # valid 48x48 I header, truncated garbage
    with pytest.raises(PictureFormatInvalid, match="validation"):
        pool.decode_step({"s": bad})
    assert pool._dims["s"] == (32, 32)  # rebucket refused
    ref = H263Decoder(SORENSON, backend="numpy")
    ref.decode_next_picture(a[0])
    out = pool.decode_step({"s": a[1]})
    np.testing.assert_array_equal(out["s"][0],
                                  ref.decode_next_picture(a[1]).as_luma())


def test_pool_bucket_error_does_not_skip_other_buckets():
    """A per-stream error in one bucket must not skip the other buckets'
    decode for that step (retrying the whole step would double-decode
    their P-frames): everything steps, then the first error surfaces with
    the partial results attached."""
    import pytest
    from h263_tpu.types import H263Error

    pool = StreamPool(SORENSON)
    a = _frames(43, 32, 32, n=3)   # bucket A
    b = _frames(44, 48, 32, n=3)   # bucket B
    pool.add_stream("a", 32, 32)
    pool.add_stream("b", 48, 32)
    pool.decode_step({"a": a[0], "b": b[0]})

    refb = H263Decoder(SORENSON, backend="numpy")
    refb.decode_next_picture(b[0])
    corrupt = a[1][:6] + b"\x00\x00\x00\x00"  # MB-layer garbage, same dims
    with pytest.raises(H263Error) as ei:
        pool.decode_step({"a": corrupt, "b": b[1]})
    partial = getattr(ei.value, "pool_step_result", None)
    assert partial is not None and "b" in partial
    np.testing.assert_array_equal(partial["b"][0],
                                  refb.decode_next_picture(b[1]).as_luma())
    # Next step: BOTH streams continue correctly (b did not double-step).
    refa = H263Decoder(SORENSON, backend="numpy")
    refa.decode_next_picture(a[0])  # a's errored frame left identity state
    out = pool.decode_step({"a": a[2], "b": b[2]})
    np.testing.assert_array_equal(out["b"][0],
                                  refb.decode_next_picture(b[2]).as_luma())


def test_pool_unregistered_mixed_id_types():
    import pytest

    pool = StreamPool(SORENSON)
    with pytest.raises(KeyError, match="unregistered"):
        pool.decode_step({"a": b"", 5: b""})


def test_standard_sniff_probe_differential():
    """The bit-probe must never answer "unchanged" when the full header
    parse would report different dims (the only correctness-critical
    direction; "changed"/None just take the slow path)."""
    from test_device_frontend import TestCarriedOptionsGate
    from test_plusptype import _plusptype_header

    from h263_tpu.bitio import BitReader
    from h263_tpu.parallel.pool import _sniff_standard_probe
    from h263_tpu.parser.picture import decode_picture
    from h263_tpu.testing.encoder import encode_standard_picture

    cases = []
    for w, h in ((128, 96), (176, 144), (352, 288)):
        cases.append(encode_standard_picture(
            w, h, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[800] * 6)]
            * ((w // 16) * (h // 16))))
    cases.append(TestCarriedOptionsGate._plusptype_qcif(umv=True))
    cases.append(_plusptype_header().to_bytes())            # custom CPFMT
    cases.append(_plusptype_header(ufep=False).to_bytes())  # inherited fmt

    for buf in cases:
        pic = decode_picture(BitReader(buf), DecoderOption.NONE, None)
        dims = pic.format.width_and_height() if pic.format else None
        for cur in ((128, 96), (176, 144), (352, 288), (120, 90)):
            probe = _sniff_standard_probe(buf, cur)
            if probe == "unchanged" and dims is not None:
                assert dims == cur, (buf.hex()[:20], cur, dims)
            if dims is not None and dims == cur and pic.format and \
                    pic.format.custom is None and not (
                        pic.has_plusptype and pic.format is None):
                # Standard-format headers at matching dims should hit the
                # fast path (perf regression guard, not correctness).
                assert probe in ("unchanged", None)


class TestAdaptiveFrontend:
    """Degraded-window adaptation: the pool must notice a collapsed
    transfer bandwidth (EMA vs the best window seen) and switch its
    buckets to the device front-end live — byte reduction is the only
    lever that works in such windows (CLAUDE.md).  The slowdown is
    injected at the measurement boundary (_transfer_stats_fn), so the
    detection logic AND the real switch mechanics both run."""

    def test_simulated_slowdown_triggers_switch_bitexact(self):
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
        from h263_tpu.utils.trace import get_counters

        n_frames = 16
        streams = {
            "a": (48, 32, _frames(21, 48, 32, n=n_frames)),
            "b": (48, 32, _frames(22, 48, 32, n=n_frames)),
            "c": (32, 32, _frames(23, 32, 32, n=n_frames)),
        }
        pool = StreamPool(SORENSON, adaptive_frontend=True,
                          degrade_ratio=4.0, adapt_min_samples=4)
        ref = StreamPool(SORENSON)  # same path, no adaptation
        for sid, (w, h, _) in streams.items():
            pool.add_stream(sid, w, h)
            ref.add_stream(sid, w, h)

        # Healthy window for 6 steps, then a 10x slowdown.
        step_no = {"t": 0}
        pool._transfer_stats_fn = lambda dec: (
            1 << 20, 0.001 if step_no["t"] < 6 else 0.010)

        switched_at = None
        for t in range(n_frames):
            step_no["t"] = t
            out = pool.decode_step(
                {sid: s[2][t] for sid, s in streams.items()})
            exp = ref.decode_step(
                {sid: s[2][t] for sid, s in streams.items()})
            if switched_at is None and pool.frontend == "device":
                switched_at = t
            for sid in streams:
                ya, cba, cra = out[sid]
                yb, cbb, crb = exp[sid]
                np.testing.assert_array_equal(ya, yb, err_msg=f"{sid}@{t}")
                np.testing.assert_array_equal(cba, cbb)
                np.testing.assert_array_equal(cra, crb)

        assert pool.frontend == "device"
        assert switched_at is not None and 6 <= switched_at < n_frames - 1, \
            f"switch mid-run so post-switch steps are exercised: {switched_at}"
        for bucket in pool._buckets.values():
            assert isinstance(bucket.dec, DeviceFrontendDecoder)
        for bucket in ref._buckets.values():
            assert isinstance(bucket.dec, BatchedStreamDecoder)
        c = get_counters()
        assert c.get("pool_degraded_window_detected", 0) >= 1
        assert c.get("pool_frontend_switches", 0) >= 2  # both buckets

    def test_healthy_window_never_switches(self):
        from h263_tpu.parallel.batch import BatchedStreamDecoder

        frames = _frames(31, 48, 32, n=10)
        pool = StreamPool(SORENSON, adaptive_frontend=True,
                          degrade_ratio=4.0, adapt_min_samples=4)
        pool.add_stream("a", 48, 32)
        pool._transfer_stats_fn = lambda dec: (1 << 20, 0.001)
        for t in range(10):
            pool.decode_step({"a": frames[t]})
        assert pool.frontend == "host"
        assert isinstance(pool._buckets[(48, 32)].dec, BatchedStreamDecoder)

    def test_manual_switch_preserves_membership_and_state(self):
        """switch_frontend mid-GOP: carried headers + reference planes
        transplant; join/leave and absent-stream semantics keep working
        on the device decoders afterwards."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        n_frames = 8
        fa = _frames(41, 48, 32, n=n_frames)
        fb = _frames(42, 48, 32, n=n_frames)
        pool = StreamPool(SORENSON)
        ref = StreamPool(SORENSON)
        for p in (pool, ref):
            p.add_stream("a", 48, 32)
            p.add_stream("b", 48, 32)
        for t in range(3):
            pool.decode_step({"a": fa[t], "b": fb[t]})
            ref.decode_step({"a": fa[t], "b": fb[t]})
        pool.switch_frontend("device")
        assert pool.frontend == "device"
        for t in range(3, n_frames):
            feed = {"a": fa[t]} if t == 4 else {"a": fa[t], "b": fb[t]}
            out = pool.decode_step(feed)
            exp = ref.decode_step(feed)
            for sid in feed:
                np.testing.assert_array_equal(out[sid][0], exp[sid][0],
                                              err_msg=f"{sid}@{t}")
        # Join after the switch lands on a device-frontend bucket.
        pool.add_stream("late", 32, 32)
        late = _frames(43, 32, 32, n=2)
        out = pool.decode_step({"a": fa[-1], "late": late[0]})
        assert isinstance(pool._buckets[(32, 32)].dec,
                          DeviceFrontendDecoder)

    def test_adaptive_requires_sorenson(self):
        import pytest

        with pytest.raises(ValueError, match="Sorenson"):
            StreamPool(DecoderOption.NONE, adaptive_frontend=True)
        pool = StreamPool(DecoderOption.NONE)
        with pytest.raises(ValueError, match="Sorenson"):
            pool.switch_frontend("device")


class TestPoolMegastep:
    """StreamPool.decode_steps: the K-frame megastep over pool buckets —
    T frames, one device dispatch per bucket — must be frame-for-frame
    identical to T sequential decode_step calls (the same state-carry
    the reference performs between decode_next_picture calls,
    state.rs:429-463, lifted into one compiled program)."""

    def _pools(self, **kw):
        return (StreamPool(SORENSON, frontend="device", **kw),
                StreamPool(SORENSON, frontend="device", **kw))

    def test_window_matches_sequential_mixed_buckets(self):
        win, seq = self._pools()
        corp = {"a": _frames(11, 48, 32, n=5), "b": _frames(12, 48, 32, n=5),
                "q": _frames(13, 32, 32, n=5)}
        for pool in (win, seq):
            pool.add_stream("a", 48, 32)
            pool.add_stream("b", 48, 32)
            pool.add_stream("q", 32, 32)
        # Frame dicts with churn: "b" absent at t=2, "q" absent at t=3.
        dicts = []
        for t in range(4):
            d = {"a": corp["a"][t]}
            if t != 2:
                d["b"] = corp["b"][t]
            if t != 3:
                d["q"] = corp["q"][t]
            dicts.append(d)
        outs = win.decode_steps(dicts)
        assert len(outs) == 4
        for t, d in enumerate(dicts):
            ref = seq.decode_step(d)
            assert set(outs[t].keys()) == set(ref.keys())
            for sid in d:
                yw, cbw, crw = outs[t][sid]
                yr, cbr, crr = ref[sid]
                np.testing.assert_array_equal(yw, yr, err_msg=f"{sid}@{t}")
                np.testing.assert_array_equal(cbw, cbr)
                np.testing.assert_array_equal(crw, crr)
        # Final pool state identical: one more sequential step on both.
        d4 = {sid: corp[sid_key][4] for sid, sid_key in
              zip(("a", "b", "q"), ("a", "b", "q"))}
        o_w = win.decode_step(d4)
        o_s = seq.decode_step(d4)
        for sid in d4:
            np.testing.assert_array_equal(o_w[sid][0], o_s[sid][0],
                                          err_msg=sid)

    def test_host_frontend_window_falls_back(self):
        pool = StreamPool(SORENSON)  # host front-end
        ref = H263Decoder(SORENSON, backend="numpy")
        frames = _frames(21, 32, 32, n=4)
        pool.add_stream("s", 32, 32)
        outs = pool.decode_steps([{"s": f} for f in frames])
        assert len(outs) == 4
        for t, f in enumerate(frames):
            pic = ref.decode_next_picture(f)
            np.testing.assert_array_equal(outs[t]["s"][0], pic.as_luma(),
                                          err_msg=f"t={t}")

    def test_window_overflow_repaired_at_sync_point(self):
        """Window overflows repair to the TRUE decode: resolve_overflows
        after a pool window replays every flagged lane's whole window
        from the pre-window planes (resolve_window_overflows), so the
        result matches the single-stream oracle even when EVERY frame of
        the window overflowed — a case the sequential single-frame
        repair contract cannot fix (its mid-run overflows chain identity
        frames into the reference)."""
        win, _ = self._pools(tape_len=8)  # tiny tape -> overflows
        frames = {"x": _frames(31, 48, 32, n=4), "y": _frames(32, 48, 32, n=4)}
        oracles = {sid: H263Decoder(SORENSON, backend="numpy")
                   for sid in frames}
        win.add_stream("x", 48, 32)
        win.add_stream("y", 48, 32)
        dicts = [{sid: frames[sid][t] for sid in frames} for t in range(4)]
        outs = win.decode_steps(dicts)
        repaired = win.resolve_overflows(outs[-1])
        assert sorted(repaired) == ["x", "y"]  # rich frames overflow 8 slots
        for sid in frames:
            for t in range(4):
                pic = oracles[sid].decode_next_picture(frames[sid][t])
            np.testing.assert_array_equal(
                np.asarray(outs[-1][sid][0]), pic.as_luma(), err_msg=sid)
            np.testing.assert_array_equal(
                np.asarray(outs[-1][sid][1]), pic.as_chroma_b())

    def test_window_resolution_change_falls_back(self):
        win, seq = self._pools()
        a_small = _frames(41, 32, 32, n=2)
        a_big = _frames(42, 48, 32, n=3)  # I-frame rebucket mid-window
        for pool in (win, seq):
            pool.add_stream("a", 32, 32)
        dicts = [{"a": a_small[0]}, {"a": a_small[1]},
                 {"a": a_big[0]}, {"a": a_big[1]}]
        outs = win.decode_steps(dicts)
        for t, d in enumerate(dicts):
            ref = seq.decode_step(d)
            np.testing.assert_array_equal(
                np.asarray(outs[t]["a"][0]), np.asarray(ref["a"][0]),
                err_msg=f"t={t}")
        assert outs[-1]["a"][0].shape == (32, 48)
