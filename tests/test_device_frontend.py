"""Differential tests: device-side entropy front-end vs the host parser.

The device front-end (parser/device_frontend.py) must produce exactly the
same dense coefficient / MV / INTER tensors as parse_frame (the Python host
parser, itself symbol-for-symbol identical to the native C++ one) for every
legal stream, and must flag status != OK exactly when the host parser
raises.  Runs on the CPU mesh (tests/conftest.py pins jax to CPU).
"""

from __future__ import annotations

import numpy as np
import pytest

from h263_tpu.bitio import BitReader
from h263_tpu.parser import device_frontend as df
from h263_tpu.parser.frame import parse_frame
from h263_tpu.parser.picture import decode_picture
from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu.types import DecoderOption, H263Error, PictureTypeCode

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def host_parse(buf: bytes, width: int, height: int, opts=SORENSON):
    """Host reference: (dense [6nmb, 64] i16, mvs, inter) or an exception."""
    r = BitReader(buf)
    pic = decode_picture(r, opts, None)
    fd = parse_frame(r, pic, opts, pic.options, width, height)
    nmb = fd.mb_w * fd.mb_h
    dense = np.concatenate([
        fd.coeffs_y.reshape(4 * nmb, 64),
        fd.coeffs_cb.reshape(nmb, 64),
        fd.coeffs_cr.reshape(nmb, 64),
    ], axis=0)
    return dense, fd.mvs, fd.inter


def device_parse(frames: list[bytes], width: int, height: int,
                 tape_len: int = 2048, opts=SORENSON):
    import jax.numpy as jnp

    mbh, mbw = -(-height // 16), -(-width // 16)
    inputs, _ = df.prepare_batch(frames, opts)
    words = df.payload_words(jnp.asarray(inputs["data_u8"]))
    tapes = df.parse_frames_device(
        words, inputs["start_bit"], inputs["nbits"], inputs["quant0"],
        inputs["ptype"], inputs["sorenson_v1"],
        mbh=mbh, mbw=mbw, tape_len=tape_len)
    dense, mvs, inter, ok = df.assemble(tapes, mbh=mbh, mbw=mbw)
    return (np.asarray(dense), np.asarray(mvs), np.asarray(inter),
            np.asarray(ok), np.asarray(tapes["status"]))


def assert_matches_host(frames, width, height, tape_len=2048, opts=SORENSON):
    dense, mvs, inter, ok, status = device_parse(
        frames, width, height, tape_len, opts=opts)
    for i, buf in enumerate(frames):
        try:
            hd, hmv, hin = host_parse(buf, width, height, opts=opts)
        except H263Error:
            assert not ok[i], f"stream {i}: host raised but device ok"
            continue
        assert ok[i], f"stream {i}: host ok but device status={status[i]}"
        np.testing.assert_array_equal(dense[i], hd, err_msg=f"stream {i} dense")
        np.testing.assert_array_equal(mvs[i], hmv, err_msg=f"stream {i} mvs")
        np.testing.assert_array_equal(inter[i], hin,
                                      err_msg=f"stream {i} inter")


def rich_gop(seed, width=48, height=32, n=5, version=1):
    max_escape = 500 if version == 1 else 127
    """A GOP exercising intra/inter/uncoded/stuffing MBs, 4V, DQUANT,
    short + both escape widths, and zigzag-overflow discards."""
    rng = np.random.default_rng(seed)
    mbw, mbh = width // 16, height // 16
    nmb = mbw * mbh

    def intra_mb():
        dcs = [int(rng.integers(1, 128)) * 8 for _ in range(6)]
        if rng.random() < 0.2:
            dcs[0] = 1024
        blocks = [[], [], [], [], [], []]
        for b in range(6):
            if rng.random() < 0.5:
                evs = []
                for _ in range(int(rng.integers(1, 4))):
                    evs.append((int(rng.integers(0, 5)),
                                int(rng.integers(1, 7)) * (1 if rng.random() < .5 else -1)))
                blocks[b] = evs
        return MBSpec(kind="intra", intradc=dcs, blocks=blocks,
                      dquant=int(rng.integers(-2, 3)) if rng.random() < .3 else 0)

    frames = [encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME,
        [intra_mb() for _ in range(nmb)], temporal_reference=0,
        version=version, quantizer=int(rng.integers(2, 14)))]

    for tr in range(1, n):
        mbs = []
        for _ in range(nmb):
            roll = rng.random()
            if roll < 0.15:
                mbs.append(MBSpec(kind="uncoded"))
                continue
            if roll < 0.25:
                mbs.append(intra_mb())
                continue
            blocks = [[], [], [], [], [], []]
            for b in range(6):
                if rng.random() < 0.45:
                    evs = []
                    for _ in range(int(rng.integers(1, 4))):
                        lvl = int(rng.integers(1, 30))
                        if rng.random() < 0.25:
                            lvl = int(rng.integers(64, max_escape))  # escapes
                        evs.append((int(rng.integers(0, 9)),
                                    lvl * (1 if rng.random() < .5 else -1)))
                    blocks[b] = evs
            if rng.random() < 0.1:
                # Zigzag overflow: run past position 63 discards the block.
                blocks[0] = [(40, 3), (40, 5)]
            four_v = rng.random() < 0.25
            mvd = [(int(rng.integers(-12, 13)), int(rng.integers(-12, 13)))
                   for _ in range(4 if four_v else 1)]
            mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks,
                              dquant=int(rng.integers(-2, 3)) if rng.random() < .3 else 0))
        if rng.random() < 0.2:
            mbs.insert(int(rng.integers(0, nmb)), MBSpec(kind="stuffing"))
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME, mbs,
            temporal_reference=tr, version=version,
            quantizer=int(rng.integers(2, 14))))
    return frames


class TestLegalStreams:
    def test_iframe_simple(self):
        nmb = 6
        f = encode_sorenson_picture(
            48, 32, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[8 * (i + 1)] * 6)
             for i in range(nmb)], temporal_reference=0)
        assert_matches_host([f], 48, 32)

    def test_rich_gop_batch(self):
        frames = []
        for seed in range(4):
            frames.extend(rich_gop(seed))
        assert_matches_host(frames, 48, 32)

    def test_sorenson_v0_escapes(self):
        frames = []
        for seed in (10, 11):
            frames.extend(rich_gop(seed, version=0))
        assert_matches_host(frames, 48, 32)

    def test_single_mb_picture(self):
        f = encode_sorenson_picture(
            16, 16, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[1024] * 6)], temporal_reference=0)
        assert_matches_host([f], 16, 16)

    def test_dquant_running_scan(self):
        mbs = [MBSpec(kind="inter", mvd=[(0, 0)],
                      blocks=[[(0, 5)], [], [], [], [], []],
                      dquant=[1, -2, 2, -1, 1, 2][i % 6])
               for i in range(6)]
        i0 = encode_sorenson_picture(
            48, 32, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[64] * 6)] * 6, temporal_reference=0)
        p = encode_sorenson_picture(
            48, 32, PictureTypeCode.P_FRAME, mbs, temporal_reference=1,
            quantizer=4)
        assert_matches_host([i0, p], 48, 32)


class TestTruncationAndErrors:
    def test_truncated_everywhere(self):
        """Every byte-truncation of a rich P-frame either matches the host
        output (EOF tail-fill) or errors on both sides.  Cuts inside the
        picture header are the host's problem (prepare_batch parses headers
        before dispatch), so truncation starts after it."""
        frames = rich_gop(42, n=2)
        buf = frames[1]
        r = BitReader(buf)
        decode_picture(r, SORENSON, None)
        first = r.pos // 8 + 1
        cuts = [buf[:k] for k in range(first, len(buf), 3)]
        assert_matches_host(cuts, 48, 32)

    def test_byte_flips(self):
        rng = np.random.default_rng(7)
        frames = rich_gop(3, n=3)
        flipped = []
        for f in (frames[1], frames[2]):
            r = BitReader(f)
            decode_picture(r, SORENSON, None)
            first = r.pos // 8 + 1  # flips in the MB layer only: header
            for _ in range(20):     # corruption is handled host-side
                b = bytearray(f)
                i = int(rng.integers(first, len(b)))
                b[i] ^= 1 << int(rng.integers(0, 8))
                flipped.append(bytes(b))
        assert_matches_host(flipped, 48, 32)

    def test_disposable_p_quirk(self):
        """Coded MBs in a DisposableP hit UnimplementedDecoding
        (macroblock.rs:461-464); all-uncoded DisposableP parses."""
        i0 = encode_sorenson_picture(
            32, 32, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[64] * 6)] * 4, temporal_reference=0)
        ok_dp = encode_sorenson_picture(
            32, 32, PictureTypeCode.DISPOSABLE_P_FRAME,
            [MBSpec(kind="uncoded")] * 4, temporal_reference=1, pad_bit=1)
        bad_dp = encode_sorenson_picture(
            32, 32, PictureTypeCode.DISPOSABLE_P_FRAME,
            [MBSpec(kind="inter", mvd=[(0, 0)])] * 4, temporal_reference=1,
            pad_bit=1)
        assert_matches_host([i0, ok_dp, bad_dp], 32, 32)

    def test_tape_overflow_flags_status(self):
        frames = rich_gop(5, n=2)
        _, _, _, ok, status = device_parse(frames, 48, 32, tape_len=8)
        assert not ok.any()
        assert (status == df.ST_TAPE_OVERFLOW).all()

    def test_error_lane_is_identity_frame(self):
        """An errored lane yields all-INTER / zero-MV / zero coefficients:
        the step reproduces the reference picture (state.rs:119-137)."""
        good = rich_gop(6, n=2)[1]
        bad = good[:10]  # truncation inside the first MB's block layer...
        dense, mvs, inter, ok, status = device_parse([bad], 48, 32)
        if not ok[0]:
            assert (dense[0] == 0).all()
            assert (mvs[0] == 0).all()
            assert inter[0].all()


class TestStandardStreams:
    """Standard (non-Sorenson) H.263 through the device automaton: the MB
    layer is shared with Sorenson except 8-bit escapes (the v0 path) and
    SOFT MCBPC/CBPY errors (host GOB resync finds no start code in an
    in-scope payload -> tail-filled picture end, frame.py:186-198)."""

    OPTS = DecoderOption.NONE

    def rich_std_gop(self, seed, n=4):
        from h263_tpu.testing.encoder import encode_standard_picture

        rng = np.random.default_rng(seed)
        W, H, nmb = 128, 96, 8 * 6
        frames = [encode_standard_picture(
            W, H, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra",
                    intradc=[int(rng.integers(1, 128)) * 8] * 6,
                    blocks=[[(int(rng.integers(0, 5)),
                              int(rng.integers(1, 9)))], [], [], [], [], []]
                    if rng.random() < 0.5 else [[]] * 6,
                    dquant=int(rng.integers(-2, 3)) if rng.random() < .3 else 0)
             for _ in range(nmb)], quantizer=int(rng.integers(2, 14)))]
        for tr in range(1, n):
            mbs = []
            for _ in range(nmb):
                roll = rng.random()
                if roll < 0.25:
                    mbs.append(MBSpec(kind="uncoded"))
                    continue
                blocks = [[]] * 6
                if rng.random() < 0.5:
                    lvl = int(rng.integers(1, 120))  # escapes past 12 mag
                    blocks = [[(int(rng.integers(0, 8)),
                                lvl if rng.random() < .5 else -lvl)],
                              [], [], [], [], []]
                kind = "inter4v" if rng.random() < 0.2 else "inter"
                mvd = [(int(rng.integers(-10, 11)), int(rng.integers(-10, 11)))
                       for _ in range(4 if kind == "inter4v" else 1)]
                mbs.append(MBSpec(kind=kind, mvd=mvd, blocks=blocks,
                                  dquant=int(rng.integers(-2, 3))
                                  if rng.random() < .3 else 0))
            frames.append(encode_standard_picture(
                W, H, PictureTypeCode.P_FRAME, mbs, temporal_reference=tr,
                quantizer=int(rng.integers(2, 14))))
        return frames

    def test_rich_gop_matches_host(self):
        frames = self.rich_std_gop(60) + self.rich_std_gop(61, n=3)
        assert_matches_host(frames, 128, 96, tape_len=4096, opts=self.OPTS)

    def test_truncations_match_host(self):
        base = self.rich_std_gop(62, n=2)[1]
        r = BitReader(base)
        decode_picture(r, self.OPTS, None)
        cuts = [base[:k] for k in range(r.pos // 8 + 1, len(base), 5)]
        assert_matches_host(cuts, 128, 96, tape_len=4096, opts=self.OPTS)

    def test_soft_mcbpc_tail_fills(self):
        """An invalid MCBPC mid-picture is a macroblock-class error: the
        host resyncs, finds no start code, and ends the picture with the
        already-decoded MBs kept + the rest tail-filled; the device lane
        must finish OK with identical tensors (not an errored lane)."""
        from h263_tpu.testing.encoder import BitWriter, encode_macroblock

        # A 13-bit pattern marked INVALID in the packed MCBPC-P table,
        # ending in 1 so byte padding can't extend it into a start code.
        inv = next(i for i in range(1 << 13)
                   if (int(df.MCBPC_P_ARR[i]) >> 25) & 1 and (i & 1))
        W, H, nmb = 128, 96, 48
        w = BitWriter()
        w.write_bits(1, 17); w.write_bits(0, 5); w.write_bits(1, 8)
        w.write_code("10"); w.write_code("000")
        w.write_bits(1, 3)              # source format: SUB-QCIF (128x96)
        w.write_bits(0, 1); w.write_bits(0, 1); w.write_bits(0, 1)
        w.write_bits(0, 1); w.write_bits(0, 1)
        w.write_bits(8, 5); w.write_bits(0, 1); w.write_bits(0, 1)
        for k in range(nmb // 2):       # half the picture decodes
            encode_macroblock(w, MBSpec(
                kind="inter", mvd=[(2, -2)],
                blocks=[[(0, 5)], [], [], [], [], []]),
                PictureTypeCode.P_FRAME, None)
        w.write_bits(0, 1)              # COD=0: coded MB follows
        w.write_bits(inv, 13)           # ...with an invalid MCBPC
        buf = w.to_bytes()
        # Only meaningful if the header round-trips at these dims.
        pic = decode_picture(BitReader(buf), self.OPTS, None)
        if pic.format is None or pic.format.width_and_height() != (W, H):
            import pytest

            pytest.skip("format bits drifted; regenerate the header")
        dense, mvs, inter, ok, status = device_parse(
            [buf], W, H, tape_len=4096, opts=self.OPTS)
        assert ok[0] and status[0] == 0, status
        hd, hmv, hin = host_parse(buf, W, H, opts=self.OPTS)
        np.testing.assert_array_equal(dense[0], hd)
        np.testing.assert_array_equal(mvs[0], hmv)
        np.testing.assert_array_equal(inter[0], hin)
        # The first half really decoded (soft end kept prior MBs).
        assert np.any(dense[0] != 0)

    def _gob_builder(self, k=5):
        """A 128x96 standard P-picture with k decoded MBs; returns the
        BitWriter positioned at the MB boundary where the resync scan will
        start (the invalid-MCBPC error rolls back to this bit)."""
        from h263_tpu.testing.encoder import BitWriter, encode_macroblock

        w = BitWriter()
        w.write_bits(1, 17); w.write_bits(0, 5); w.write_bits(1, 8)
        w.write_code("10"); w.write_code("000")
        w.write_bits(1, 3)              # source format: 128x96
        for _ in range(5):              # P-frame, no options
            w.write_bits(0, 1)
        w.write_bits(8, 5); w.write_bits(0, 1); w.write_bits(0, 1)
        for _ in range(k):
            encode_macroblock(w, MBSpec(
                kind="inter", mvd=[(2, -2)],
                blocks=[[(0, 5)], [], [], [], [], []]),
                PictureTypeCode.P_FRAME, None)
        return w

    def _gob_case(self, gn, stuff, k=5):
        """k MBs, then `stuff` zero bits + the 17-bit start code + GN."""
        w = self._gob_builder(k)
        w.write_code("0" * stuff)
        w.write_bits(1, 17)
        w.write_bits(gn, 5)
        w.write_code("11")              # keep byte padding off the code
        return w.to_bytes(pad_bit=1)

    def test_gob_resync_routes_in_automaton(self):
        """GOB-bearing standard payloads dispatch since round 4 late: on
        the soft MB error at the GOB boundary the automaton runs the
        host's recognize_start_code scan in-lane (gob.rs:21-42 stub
        parity).  GN in {0, 15} = picture boundary -> the lane ends OK,
        tail-filled, with the prior MBs kept; GN in 1..14 = a real GOB
        header -> the frame fails with UnimplementedDecoding."""
        from h263_tpu.types import UnimplementedDecoding

        probe = self._gob_case(0, 0)
        pic = decode_picture(BitReader(probe), self.OPTS, None)
        if pic.format is None or pic.format.width_and_height() != (128, 96):
            import pytest

            pytest.skip("format bits drifted; regenerate the header")

        # Picture boundary: tail-filled end, bit-identical to the host.
        for gn in (0, 15):
            buf = self._gob_case(gn, 0)
            dense, mvs, inter, ok, status = device_parse(
                [buf], 128, 96, tape_len=4096, opts=self.OPTS)
            assert ok[0] and status[0] == 0, status
            hd, hmv, hin = host_parse(buf, 128, 96, opts=self.OPTS)
            np.testing.assert_array_equal(dense[0], hd)
            np.testing.assert_array_equal(mvs[0], hmv)
            np.testing.assert_array_equal(inter[0], hin)
            assert np.any(dense[0] != 0)  # the k decoded MBs were kept

        # Real GOB header: UnimplementedDecoding on both front-ends.
        buf = self._gob_case(5, 0)
        try:
            host_parse(buf, 128, 96, opts=self.OPTS)
            raise AssertionError("host accepted a real GOB header")
        except UnimplementedDecoding:
            pass
        _, _, _, ok, status = device_parse(
            [buf], 128, 96, tape_len=4096, opts=self.OPTS)
        assert not ok[0] and status[0] == df.ST_UNIMPLEMENTED, status

    def test_gob_resync_differential_sweep(self):
        """Stuffing distances x GN values x EOF-mid-code truncations, all
        differentially vs the host parser (the scan's accept/reject and
        EOF outcomes must agree bit-for-bit)."""
        frames = [self._gob_case(gn, s)
                  for gn in (0, 1, 5, 14, 15) for s in (0, 2, 5, 9)]
        base = self._gob_case(5, 0)
        frames += [base[:-2], base[:-3]]  # EOF inside the scan window
        assert_matches_host(frames, 128, 96, tape_len=4096, opts=self.OPTS)

    def test_gob_resync_off_by_one_skip_bound(self):
        """recognize_start_code accepts a code up to max_skip+1 bits ahead
        (the reference off-by-one, bitio.py:104-110): at stuff=align+1 the
        GN=5 header is FOUND (frame fails, both front-ends); at
        stuff=align+2 the scan gives up -> tail-filled OK end."""
        from h263_tpu.types import UnimplementedDecoding

        w = self._gob_builder()
        align = (8 - len(w._bits) % 8) % 8
        found = self._gob_case(5, align + 1)
        missed = self._gob_case(5, align + 2)
        try:
            host_parse(found, 128, 96, opts=self.OPTS)
            raise AssertionError("host accepted a code at align+1? "
                                 "(off-by-one regressed)")
        except UnimplementedDecoding:
            pass
        hd, hmv, hin = host_parse(missed, 128, 96, opts=self.OPTS)
        dense, mvs, inter, ok, status = device_parse(
            [found, missed], 128, 96, tape_len=4096, opts=self.OPTS)
        assert not ok[0] and status[0] == df.ST_UNIMPLEMENTED, status
        assert ok[1] and status[1] == 0, status
        np.testing.assert_array_equal(dense[1], hd)
        np.testing.assert_array_equal(mvs[1], hmv)
        np.testing.assert_array_equal(inter[1], hin)

    def test_decoder_end_to_end_standard(self):
        from h263_tpu.decoder.state import H263Decoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [self.rich_std_gop(70 + i, n=3) for i in range(2)]
        dec = DeviceFrontendDecoder(2, 128, 96, self.OPTS)
        oracles = [H263Decoder(self.OPTS, backend="numpy") for _ in range(2)]
        for t in range(3):
            y, cb, cr = dec.decode_step([streams[i][t] for i in range(2)])
            assert (dec.fetch_status() == 0).all()
            for i in range(2):
                pic = oracles[i].decode_next_picture(streams[i][t])
                np.testing.assert_array_equal(
                    np.asarray(y[i]), pic.as_luma(),
                    err_msg=f"stream {i} frame {t}")
                np.testing.assert_array_equal(
                    np.asarray(cb[i]), pic.as_chroma_b())


def test_differential_fuzz_campaign_device():
    """Device-automaton flavor of the differential fuzz: random d24-biased
    frames + structured mutations (byte flips, truncations, splices,
    garbage tails) through the device entropy automaton vs the Python host
    parser — identical dense/MV/INTER tensors on success, matching error
    classes on failure (df.status_error_class).  A 5,280-case campaign
    (seeds 11-14, n_base=120 each) ran clean in round 3."""
    from h263_tpu.testing.fuzz import run_campaign

    failures = []
    total, fails = run_campaign(seed=11, n_base=8, mutations_per_base=5,
                                flavor="device",
                                on_fail=lambda tag, why: failures.append((tag, why)))
    assert fails == 0, failures[:5]
    assert total == 8 * 6


def test_differential_fuzz_campaign_device_std():
    """Standard-H.263 flavor of the device differential fuzz: plain-PTYPE
    pictures (8-bit escapes, soft MCBPC/CBPY semantics, the UMV half of
    the generator exercising the supports() gate) vs the Python parser.
    A 4,950-case campaign (seeds 51-53) ran clean in round 3."""
    from h263_tpu.testing.fuzz import run_campaign

    failures = []
    total, fails = run_campaign(seed=51, n_base=6, mutations_per_base=5,
                                flavor="device_std",
                                on_fail=lambda tag, why: failures.append((tag, why)))
    assert fails == 0, failures[:5]
    assert total == 6 * 6


def test_differential_fuzz_campaign_device_umv():
    """UMV flavor of the device differential fuzz: PLUSPTYPE UMV pictures
    (table-D.3 fixed-code MVDs, EXTENDED and UNLIMITED motion-vector
    ranges, INTER4V, large mantissas) + structured mutations vs the
    Python parser — the automaton's round-4 scope extension."""
    from h263_tpu.testing.fuzz import run_campaign

    failures = []
    total, fails = run_campaign(seed=71, n_base=6, mutations_per_base=5,
                                flavor="device_umv",
                                on_fail=lambda tag, why: failures.append((tag, why)))
    assert fails == 0, failures[:5]
    assert total == 6 * 6


class TestNativePrep:
    def test_matches_python_prepare_batch(self):
        """DevicePrepBatch (one FFI call) fills the same meta rows and
        payload bytes as the Python header loop."""
        from h263_tpu.native import ensure_built

        if not ensure_built():
            pytest.skip("native unavailable")
        from h263_tpu.native.bindings import DevicePrepBatch

        frames = rich_gop(800, n=3) + [rich_gop(801, n=1, version=0)[0]]
        n = len(frames)
        inputs, _ = df.prepare_batch(frames, SORENSON,
                                     max_bytes=2048)
        Lw = (2048 + 3) // 4
        stage = np.ones((n, Lw, 4), dtype=np.uint8)  # dirty: prep must clear
        meta = np.zeros((5, n), dtype=np.int32)
        prep = DevicePrepBatch(n, 48, 32, Lw * 4)
        failed = prep.prepare(frames, stage, meta)
        assert failed == 0
        np.testing.assert_array_equal(meta[0], inputs["start_bit"])
        np.testing.assert_array_equal(meta[1], inputs["nbits"])
        np.testing.assert_array_equal(meta[2], inputs["quant0"])
        np.testing.assert_array_equal(meta[3], inputs["ptype"])
        np.testing.assert_array_equal(meta[4], inputs["sorenson_v1"])
        np.testing.assert_array_equal(stage, inputs["data_u8"])

    def test_rejects_wrong_bucket_and_oversize(self):
        from h263_tpu.native import ensure_built

        if not ensure_built():
            pytest.skip("native unavailable")
        from h263_tpu.native.bindings import DevicePrepBatch

        good = rich_gop(810, n=1)[0]          # 48x32
        wrong = rich_gop(811, n=1, width=32, height=32)[0]
        Lw = 64
        stage = np.ones((3, Lw, 4), dtype=np.uint8)
        meta = np.zeros((5, 3), dtype=np.int32)
        prep = DevicePrepBatch(3, 48, 32, Lw * 4)
        big = good + b"\x00" * Lw * 4
        failed = prep.prepare([good, wrong, big], stage, meta)
        assert failed == 2 and prep.rc[0] == 0
        assert prep.rc[1] != 0 and prep.rc[2] != 0
        # Failed rows stage as empty streams -> identity frames.
        assert meta[1, 1] == 0 and meta[1, 2] == 0
        assert (stage[1] == 0).all() and (stage[2] == 0).all()


class TestDeviceFrontendDecoder:
    """Full pipeline: DeviceFrontendDecoder vs the single-stream oracle and
    the host-front-end batched decoder, over multi-frame GOPs."""

    def test_gop_matches_single_stream_oracle(self):
        from h263_tpu.decoder.state import H263Decoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(100 + i, n=4) for i in range(3)]
        dec = DeviceFrontendDecoder(3, 48, 32, SORENSON)
        oracles = [H263Decoder(SORENSON, backend="numpy") for _ in range(3)]
        for t in range(4):
            y, cb, cr = dec.decode_step([streams[i][t] for i in range(3)])
            assert (dec.fetch_status() == 0).all()
            for i in range(3):
                pic = oracles[i].decode_next_picture(streams[i][t])
                np.testing.assert_array_equal(
                    np.asarray(y[i]), pic.as_luma(),
                    err_msg=f"stream {i} frame {t} luma")
                np.testing.assert_array_equal(
                    np.asarray(cb[i]), pic.as_chroma_b(),
                    err_msg=f"stream {i} frame {t} cb")
                np.testing.assert_array_equal(
                    np.asarray(cr[i]), pic.as_chroma_r(),
                    err_msg=f"stream {i} frame {t} cr")

    def test_unroll_factor_is_semantics_preserving(self):
        """Any while_loop-body unroll factor decodes identically (finished
        lanes pass extra sub-steps as masked no-ops)."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(500 + i, n=3) for i in range(2)]
        a = DeviceFrontendDecoder(2, 48, 32, SORENSON, unroll=1)
        b = DeviceFrontendDecoder(2, 48, 32, SORENSON, unroll=5)
        for t in range(3):
            bufs = [streams[i][t] for i in range(2)]
            ya, cba, cra = a.decode_step(bufs)
            yb, cbb, crb = b.decode_step(bufs)
            np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
            np.testing.assert_array_equal(np.asarray(cba), np.asarray(cbb))
            np.testing.assert_array_equal(np.asarray(cra), np.asarray(crb))
        np.testing.assert_array_equal(a.fetch_status(), b.fetch_status())

    def test_retired_pallas_harness_rejected(self):
        """The Pallas parse harness was retired in round 5 (it never
        lowered through Mosaic: the per-lane VLC-table gathers); asking
        for it must fail loudly at construction, never silently demote."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        for h in ("pallas", "pallas_interpret", "mosaic"):
            with pytest.raises(ValueError, match="retired|unknown"):
                DeviceFrontendDecoder(2, 48, 32, SORENSON, harness=h)

    def test_matches_host_batched_decoder(self):
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(200 + i, n=4) for i in range(4)]
        dev = DeviceFrontendDecoder(4, 48, 32, SORENSON)
        host = BatchedStreamDecoder(4, 48, 32, SORENSON)
        for t in range(4):
            bufs = [streams[i][t] for i in range(4)]
            ya, cba, cra = dev.decode_step(bufs)
            yb, cbb, crb = host.decode_step(bufs)
            np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
            np.testing.assert_array_equal(np.asarray(cba), np.asarray(cbb))
            np.testing.assert_array_equal(np.asarray(cra), np.asarray(crb))

    def test_corrupt_stream_isolated(self):
        """A corrupted stream decodes to the identity frame (reference
        persists) without disturbing its batch neighbors; its status is
        nonzero at the sync point."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(300 + i, n=3) for i in range(2)]
        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON)
        y0, _, _ = dec.decode_step([streams[0][0], streams[1][0]])
        ref0 = np.asarray(y0)
        # Frame 1: stream 1's payload is cut inside the block layer.
        cut = streams[1][1][:14]
        y1, _, _ = dec.decode_step([streams[0][1], cut])
        status = dec.fetch_status()
        if status[1] != 0:
            np.testing.assert_array_equal(np.asarray(y1)[1], ref0[1])
        # Stream 0 decoded normally either way; next frame still works.
        y2, _, _ = dec.decode_step([streams[0][2], streams[1][2]])

    def test_present_rgba_matches_host_path(self):
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(400 + i, n=2) for i in range(2)]
        dev = DeviceFrontendDecoder(2, 48, 32, SORENSON)
        host = BatchedStreamDecoder(2, 48, 32, SORENSON)
        for t in range(2):
            bufs = [streams[i][t] for i in range(2)]
            dev.decode_step(bufs)
            host.decode_step(bufs)
        np.testing.assert_array_equal(
            np.asarray(dev.present_rgba(deblock=True)),
            np.asarray(host.present_rgba(deblock=True)))

    def test_resolve_overflows_repairs_via_host(self):
        """ST_TAPE_OVERFLOW is a capacity artifact, not a stream error: a
        legal frame that exhausts the tape leaves the identity frame, and
        resolve_overflows() re-decodes it host-side at the sync point —
        after which the GOP continues bit-identically to the host path."""
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(700 + i, n=4) for i in range(2)]
        # tape_len 512 fits these 48x32 frames; a 6-slot tape does not.
        dev = DeviceFrontendDecoder(2, 48, 32, SORENSON, tape_len=512)
        tiny = DeviceFrontendDecoder(2, 48, 32, SORENSON, tape_len=8)
        host = BatchedStreamDecoder(2, 48, 32, SORENSON)
        for t in range(4):
            bufs = [streams[i][t] for i in range(2)]
            dec = tiny if t == 2 else dev
            if t > 0 and dec is tiny:
                # carry state across decoders (same plane shapes)
                tiny.ref_y, tiny.ref_cb, tiny.ref_cr = (
                    dev.ref_y, dev.ref_cb, dev.ref_cr)
            y, cb, cr = dec.decode_step(bufs)
            if dec is tiny:
                status = tiny.fetch_status()
                assert (status == df.ST_TAPE_OVERFLOW).all()
                repaired = tiny.resolve_overflows(status)
                assert repaired == [0, 1]
                assert (tiny.fetch_status() == 0).all()
                dev.ref_y, dev.ref_cb, dev.ref_cr = (
                    tiny.ref_y, tiny.ref_cb, tiny.ref_cr)
            else:
                assert (dev.fetch_status() == 0).all()
            yh, cbh, crh = host.decode_step(bufs)
            src = tiny if dec is tiny else dev
            np.testing.assert_array_equal(np.asarray(src.ref_y),
                                          np.asarray(yh), err_msg=f"t={t}")
            np.testing.assert_array_equal(np.asarray(src.ref_cb),
                                          np.asarray(cbh), err_msg=f"t={t}")
            np.testing.assert_array_equal(np.asarray(src.ref_cr),
                                          np.asarray(crh), err_msg=f"t={t}")

    def test_absent_stream_keeps_planes(self):
        """A None buffer decodes the skip frame: planes and state persist,
        and the stream resumes cleanly on the next real frame."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(600 + i, n=3) for i in range(2)]
        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON)
        y0, _, _ = dec.decode_step([streams[0][0], streams[1][0]])
        ref1 = np.asarray(y0)[1].copy()
        quant1 = int(dec._last_quant[1])
        y1, _, _ = dec.decode_step([streams[0][1], None])
        assert (dec.fetch_status() == 0).all()
        np.testing.assert_array_equal(np.asarray(y1)[1], ref1)
        # Presentation params (quant -> deblock strength) survive absence:
        # the skip frame's header must not commit.
        assert int(dec._last_quant[1]) == quant1
        # Stream 1 skipped frame 1; from the decoder's perspective its next
        # frame predicts against frame 0's planes — same as a fresh decoder
        # fed frames {0, 2}.
        y2, _, _ = dec.decode_step([streams[0][2], streams[1][2]])
        solo = DeviceFrontendDecoder(1, 48, 32, SORENSON)
        sy, _, _ = solo.decode_step([streams[1][0]])
        sy, _, _ = solo.decode_step([streams[1][2]])
        np.testing.assert_array_equal(np.asarray(y2)[1], np.asarray(sy)[0])

    def test_oversized_frame_raises_and_skips(self):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
        from h263_tpu.types import H263Error

        streams = [rich_gop(500 + i, n=2) for i in range(2)]
        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON,
                                    max_frame_bytes=64)
        big = streams[1][0] + b"\x00" * 80
        with pytest.raises(H263Error):
            dec.decode_step([streams[0][0], big])


class TestCarriedOptionsGate:
    """The supports() gate must see CARRIED running options: a plain-PTYPE
    picture after an OPPTYPE carrying a host-only option (MODIFIED_
    QUANTIZATION) still decodes under it (state.rs:147-155) and must stay
    on the host front-end, not silently mis-decode.  UMV — host-gated
    until round 4 — now decodes ON the automaton; the carried options
    must reach encode_ptype so the follow-up picture uses the UMV range
    rules its own bits don't announce."""

    @staticmethod
    def _plusptype_qcif(*, umv=False, mq=False, p=False, mbs=None):
        """PLUSPTYPE+OPPTYPE I-picture: source format QCIF (standard, so a
        plain-PTYPE QCIF follow-up is format-compatible — a format CHANGE
        would trip the RPRP quirk instead).  `mbs`: optional MB payload
        (encoded with table-D.3 MVDs when umv, the PLUSPTYPE coding)."""
        from h263_tpu.testing.encoder import BitWriter, encode_macroblock

        w = BitWriter()
        w.write_bits(1, 17)          # PSC
        w.write_bits(0, 5)           # GN
        w.write_bits(5, 8)           # TR
        w.write_code("10000")        # PTYPE intro
        w.write_code("111")          # source format 7 => PLUSPTYPE
        w.write_code("001")          # UFEP: OPPTYPE present
        w.write_code("010")          # OPPTYPE fmt = QCIF (standard)
        w.write_bits(0, 1)           # custom PCF off
        w.write_bits(1 if umv else 0, 1)   # UMV (Annex D)
        w.write_bits(0, 8)           # SAC..AIV off
        w.write_bits(1 if mq else 0, 1)    # MODIFIED_QUANTIZATION
        w.write_code("1000")         # mandatory tail
        w.write_code("001" if p else "000")   # MPPTYPE: P / I
        w.write_code("000")          # rprp/rru/rounding off
        w.write_code("001")          # mandatory tail
        w.write_bits(0, 1)           # CPM off
        if umv:
            w.write_bits(1, 1)       # UUI: '1' => extended range
        w.write_bits(9, 5)           # PQUANT
        w.write_bits(0, 1)           # PEI end
        for mb in (mbs or []):
            encode_macroblock(
                w, mb,
                PictureTypeCode.P_FRAME if p else PictureTypeCode.I_FRAME,
                None, umv_d3=umv)
        return w.to_bytes()

    def test_carried_mq_runs_in_automaton(self):
        """Round 5: MODIFIED_QUANTIZATION is automaton scope.  A coded MB
        in an MQ picture fails with the reference's UnimplementedDecoding
        (macroblock.rs:497-498: raised after CBPY, before DQUANT); an
        all-uncoded MQ picture DECODES — and the carried MQ option binds
        plain-PTYPE follow-ups exactly as it does on the host."""
        import h263_tpu.parser.device_frontend as dfm
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
        from h263_tpu.testing.encoder import encode_standard_picture
        from h263_tpu.types import PictureOption, UnimplementedDecoding

        f0 = self._plusptype_qcif(
            mq=True,
            mbs=[MBSpec(kind="intra", intradc=[8 * (1 + i % 120)] * 6)
                 for i in range(99)])
        f1 = encode_standard_picture(
            176, 144, PictureTypeCode.P_FRAME,
            [MBSpec(kind="uncoded")] * 99, temporal_reference=6)
        f2 = encode_standard_picture(
            176, 144, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, -2)],
                    blocks=[[(0, 4)], [], [], [], [], []])]
            + [MBSpec(kind="uncoded")] * 98, temporal_reference=7)

        dec = DeviceFrontendDecoder(1, 176, 144, DecoderOption.NONE)
        # Coded intra MBs under MQ: UnimplementedDecoding, frame -> identity.
        dec.decode_step([f0])
        st = dec.fetch_status()
        assert st[0] == dfm.ST_UNIMPLEMENTED
        assert dfm.status_error_class(int(st[0])) is UnimplementedDecoding
        assert dec._running[0] & PictureOption.MODIFIED_QUANTIZATION
        # All-uncoded P under carried MQ decodes (host parity: the MQ
        # raise sits inside the coded-MB path only).
        dec.decode_step([f1])
        assert (dec.fetch_status() == 0).all()
        # A coded MB in the plain-PTYPE follow-up still fails: the RUNNING
        # options carry MQ even though the frame's own bits do not.
        dec.decode_step([f2])
        assert dec.fetch_status()[0] == dfm.ST_UNIMPLEMENTED
        # Fresh slot (no carried MQ): the same coded frame decodes.
        dec.reset_slot_state(0)
        dec.decode_step([f1])
        dec.decode_step([f2])
        assert (dec.fetch_status() == 0).all()

    def test_carried_umv_decodes_on_device(self):
        """Round 4: UMV is automaton scope.  A plain-PTYPE P follow-up
        under carried UMV must decode on the device path with the v1
        range rules (its own bits carry no UMV) and match the host
        batched decoder plane-for-plane."""
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
        from h263_tpu.testing.encoder import encode_standard_picture
        from h263_tpu.types import PictureOption

        # A real intra payload: an empty I raises UncodedIFrameBlocks and
        # a P with no reference is rejected by gather.rs:149 semantics.
        f0 = self._plusptype_qcif(
            umv=True,
            mbs=[MBSpec(kind="intra", intradc=[8 * (1 + i % 120)] * 6)
                 for i in range(99)])
        mbs = []
        for i in range(99):
            if i % 7 == 0:
                mbs.append(MBSpec(kind="inter", mvd=[(5 - (i % 11), 3)],
                                  blocks=[[(0, 4)], [], [], [], [], []]))
            else:
                mbs.append(MBSpec(kind="uncoded"))
        f1 = encode_standard_picture(
            176, 144, PictureTypeCode.P_FRAME, mbs, temporal_reference=6)

        dev = DeviceFrontendDecoder(1, 176, 144, DecoderOption.NONE)
        host = BatchedStreamDecoder(1, 176, 144, DecoderOption.NONE)
        for f in (f0, f1):
            ya, cba, cra = dev.decode_step([f])
            yb, cbb, crb = host.decode_step([f])
            np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
            np.testing.assert_array_equal(np.asarray(cba), np.asarray(cbb))
            np.testing.assert_array_equal(np.asarray(cra), np.asarray(crb))
        assert dev._running[0] & PictureOption.UNRESTRICTED_MOTION_VECTORS
        assert (dev.fetch_status() == 0).all()

    def test_recycled_slot_does_not_inherit_status(self):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(700 + i, n=1) for i in range(2)]
        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON, tape_len=4)
        dec.decode_step([streams[i][0] for i in range(2)])
        st = dec.fetch_status()
        assert (st != 0).all()  # tiny tape: both lanes overflow
        dec.reset_slot_state(0)
        st = dec.fetch_status()
        assert st[0] == 0 and st[1] != 0

    def test_dispatch_failure_keeps_buffer_reuse_gate(self):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        def exploding_step(*a):
            raise RuntimeError("injected dispatch failure")

        dec = DeviceFrontendDecoder(1, 32, 32, SORENSON,
                                    step_fn=exploding_step)
        with pytest.raises(RuntimeError, match="injected"):
            dec.decode_step([_gop_like_frame()])
        # The staged host buffer's async device_put must stay gated: the
        # in-flight slot holds the transferred arrays, so the next reuse
        # of this ping-pong buffer blocks until the transfer completes
        # (CLAUDE.md HOST BUFFER REUSE GATE).
        pp = next(iter(dec._stage_pp.values()))
        assert pp["in_flight"][pp["idx"]] is not None


class TestTransferBuckets:
    """The per-step payload bucket ladder: ship the smallest bucket that
    covers the step's longest frame instead of padding every step to the
    decoder cap (4-5x transfer waste on typical content)."""

    def test_pick_bucket(self):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        dec = DeviceFrontendDecoder(3, 48, 32, SORENSON)
        assert dec._buckets == [1024, 2048, 4096, 8192]
        assert dec._pick_bucket([b"x" * 10, b"y" * 900, b"z" * 10]) == 1024
        assert dec._pick_bucket([b"x" * 1025, b"", b""]) == 2048
        assert dec._pick_bucket([b"x" * 5000, b"", b""]) == 8192
        # Absent and over-cap payloads stage the skip frame, so they count
        # at its length, not theirs.
        skiplen = len(dec._skip_frame_bytes())
        want = dec._pick_bucket([b"a" * skiplen, b"", b""])
        assert dec._pick_bucket([None, b"", b""]) == want
        assert dec._pick_bucket([b"x" * 9001, b"", b""]) == want

    def test_gop_spanning_buckets_matches_oracle(self):
        """Steps landing in different buckets decode identically to the
        single-stream oracle (each bucket is its own staging pair + jit
        specialization)."""
        from h263_tpu.decoder.state import H263Decoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        nmb = 6  # 48x32
        fat_blocks = [[(1, 100)] * 30 for _ in range(6)]
        fat = encode_sorenson_picture(
            48, 32, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[800] * 6, blocks=fat_blocks)
             for _ in range(nmb)], temporal_reference=0, version=1)
        assert len(fat) > 2048  # lands above the smallest buckets
        thin = encode_sorenson_picture(
            48, 32, PictureTypeCode.P_FRAME,
            [MBSpec(kind="uncoded")] * nmb, temporal_reference=1, version=1)
        medium = rich_gop(321, n=2, version=1)[1]

        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON, tape_len=2048)
        oracles = [H263Decoder(SORENSON, backend="numpy") for _ in range(2)]
        for t, frame in enumerate([fat, thin, medium]):
            y, cb, cr = dec.decode_step([frame, frame])
            assert (dec.fetch_status() == 0).all()
            for i in range(2):
                pic = oracles[i].decode_next_picture(frame)
                np.testing.assert_array_equal(
                    np.asarray(y[i]), pic.as_luma(),
                    err_msg=f"stream {i} frame {t} luma")
                np.testing.assert_array_equal(
                    np.asarray(cb[i]), pic.as_chroma_b(),
                    err_msg=f"stream {i} frame {t} cb")
                np.testing.assert_array_equal(
                    np.asarray(cr[i]), pic.as_chroma_r(),
                    err_msg=f"stream {i} frame {t} cr")
        assert len(dec._stage_pp) >= 2  # the GOP really spanned buckets


def _gop_like_frame():
    rng = np.random.default_rng(0)
    return encode_sorenson_picture(
        32, 32, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
         for _ in range(4)], temporal_reference=0)


class TestRaggedPayload:
    """The ragged (flat words + per-lane base offsets) payload layout vs
    the rows layout — observably identical to the automaton, but shipping
    ~sum(len) bytes instead of S * bucket(max len) per step
    (device_frontend.make_step ragged mode; entropy.cpp
    h263_device_prepare_ragged)."""

    def _pair(self, n, w, h, **kw):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        rows = DeviceFrontendDecoder(n, w, h, SORENSON, payload="rows", **kw)
        rag = DeviceFrontendDecoder(n, w, h, SORENSON, payload="ragged",
                                    **kw)
        assert rows.payload == "rows" and rag.payload == "ragged"
        return rows, rag

    def _assert_step_equal(self, rows, rag, bufs, mask=None):
        first_rows = first_rag = None
        try:
            y1, cb1, cr1 = rows.decode_step(bufs, mask=mask)
        except H263Error as e:
            first_rows = e
            y1, cb1, cr1 = rows.ref_y, rows.ref_cb, rows.ref_cr
        try:
            y2, cb2, cr2 = rag.decode_step(bufs, mask=mask)
        except H263Error as e:
            first_rag = e
            y2, cb2, cr2 = rag.ref_y, rag.ref_cb, rag.ref_cr
        assert (first_rows is None) == (first_rag is None)
        np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
        np.testing.assert_array_equal(np.asarray(cb1), np.asarray(cb2))
        np.testing.assert_array_equal(np.asarray(cr1), np.asarray(cr2))
        np.testing.assert_array_equal(rows.fetch_status(),
                                      rag.fetch_status())

    def test_rich_gops_match_rows(self):
        streams = [rich_gop(700 + i, n=4) for i in range(3)]
        rows, rag = self._pair(3, 48, 32)
        for t in range(4):
            self._assert_step_equal(rows, rag,
                                    [streams[i][t] for i in range(3)])

    def test_absent_overcap_and_error_lanes(self):
        """Absent (None) lanes, an over-frame-cap lane, and a garbage-
        header lane behave identically across layouts, including the
        surfaced host error and per-lane isolation."""
        streams = [rich_gop(710 + i, n=4) for i in range(4)]
        rows, rag = self._pair(4, 48, 32, max_frame_bytes=4096)
        for t in range(4):
            bufs = [streams[i][t] for i in range(4)]
            if t == 1:
                bufs[1] = None                    # absent lane
            if t == 2:
                bufs[2] = b"\xff" * 5000          # over the per-frame cap
            if t == 3:
                bufs[3] = b"\x00\x01\x02"         # unparseable header
            self._assert_step_equal(rows, rag, bufs)

    def test_varied_lengths_pick_small_bucket(self):
        """The ragged bucket is driven by the SUM of lane payloads; one
        long lane must not multiply the leaf by S the way the rows
        max-lane bucket does."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        rag = DeviceFrontendDecoder(8, 48, 32, SORENSON, payload="ragged")
        short = rich_gop(720, n=1)[0]
        bufs = [short] * 8
        need = sum(((len(b) + 3) // 4) * 4 for b in bufs)
        bucket = rag._pick_bucket_ragged(bufs)
        assert need <= bucket <= max(4096, int(need * 1.19) + 4)

    def test_ragged_rejects_injected_step_and_bad_layout(self):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        with pytest.raises(ValueError):
            DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="ragged",
                                  step_fn=lambda *a: None)
        with pytest.raises(ValueError):
            DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="nope")

    def test_native_ragged_prep_offsets(self):
        """Unit-level: offsets are the word-aligned running sum, payload
        bytes land verbatim at them, tails and failed lanes stage zeros."""
        from h263_tpu.native import ensure_built

        if not ensure_built():
            pytest.skip("native library unavailable")
        from h263_tpu.native.bindings import DevicePrepBatch

        frames = rich_gop(730, n=3)
        bufs = [frames[0], b"\x00\x01\x02", frames[1]]  # lane 1 fails
        prep = DevicePrepBatch(3, 48, 32, 8192)
        stage = np.full((4096, 4), 0xAA, dtype=np.uint8)
        meta = np.zeros((6, 3), dtype=np.int32)
        failed = prep.prepare_ragged(bufs, stage, meta)
        assert failed == 1 and prep.rc[1] != 0
        flat = stage.reshape(-1)
        base = meta[5]
        w0 = (len(bufs[0]) + 3) // 4
        assert base[0] == 0 and base[1] == w0 and base[2] == w0
        np.testing.assert_array_equal(
            flat[:len(bufs[0])], np.frombuffer(bufs[0], dtype=np.uint8))
        np.testing.assert_array_equal(
            flat[base[2] * 4:base[2] * 4 + len(bufs[2])],
            np.frombuffer(bufs[2], dtype=np.uint8))
        # Word-pad tail of lane 2 and everything beyond is zero.
        end = base[2] * 4 + len(bufs[2])
        assert not flat[end:].any()
        assert meta[1, 1] == 0  # failed lane stages nbits = 0


class TestDecodeStepsWindow:
    """decode_steps: a T-frame window through ONE device dispatch
    (lax.scan chains the reference planes in-program) must be frame-for-
    frame identical to T sequential decode_step calls — the same
    state-carry the reference performs between decode_next_picture calls
    (state.rs:429-463), lifted into the compiled program."""

    def _decoders(self, n, tape_len=None):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        kw = dict(tape_len=tape_len) if tape_len else {}
        a = DeviceFrontendDecoder(n, 48, 32, SORENSON, payload="ragged", **kw)
        b = DeviceFrontendDecoder(n, 48, 32, SORENSON, payload="ragged", **kw)
        return a, b

    def test_window_matches_sequential_steps(self):
        streams = [rich_gop(810 + i, n=4) for i in range(3)]
        win, seq = self._decoders(3)
        lists = [[streams[i][t] for i in range(3)] for t in range(4)]
        ys, cbs, crs = win.decode_steps(lists)
        status = np.asarray(win.last_status_steps)
        for t in range(4):
            y, cb, cr = seq.decode_step(lists[t])
            np.testing.assert_array_equal(np.asarray(ys[t]), np.asarray(y),
                                          err_msg=f"t={t} luma")
            np.testing.assert_array_equal(np.asarray(cbs[t]), np.asarray(cb))
            np.testing.assert_array_equal(np.asarray(crs[t]), np.asarray(cr))
            np.testing.assert_array_equal(status[t], seq.fetch_status(),
                                          err_msg=f"t={t} status")
        # Final refs and [S]-shaped last_status match the sequential tail.
        np.testing.assert_array_equal(np.asarray(win.ref_y),
                                      np.asarray(seq.ref_y))
        np.testing.assert_array_equal(np.asarray(win.last_status),
                                      seq.fetch_status())

    def test_window_absent_lane_and_block_error(self):
        """None slots (skip frame, commit suppressed) and a mid-window
        block-layer corruption behave exactly as in sequential stepping;
        neighbors are untouched."""
        streams = [rich_gop(830 + i, n=4) for i in range(2)]
        win, seq = self._decoders(2)
        lists = [[streams[i][t] for i in range(2)] for t in range(4)]
        lists[1][1] = None                      # absent
        lists[2][1] = streams[1][2][:14]        # cut inside block layer
        ys, cbs, crs = win.decode_steps(lists)
        status = np.asarray(win.last_status_steps)
        for t in range(4):
            y, _, _ = seq.decode_step(lists[t])
            np.testing.assert_array_equal(np.asarray(ys[t]), np.asarray(y),
                                          err_msg=f"t={t}")
            np.testing.assert_array_equal(status[t], seq.fetch_status(),
                                          err_msg=f"t={t} status")

    def test_window_header_reject_surfaces_after_dispatch(self):
        streams = [rich_gop(850 + i, n=3) for i in range(2)]
        win, seq = self._decoders(2)
        lists = [[streams[i][t] for i in range(2)] for t in range(3)]
        lists[1][0] = b"\x12\x34\x56"           # header garbage
        with pytest.raises(H263Error):
            win.decode_steps(lists)
        for t in range(3):
            try:
                seq.decode_step(lists[t])
            except H263Error:
                pass
        # The window still decoded: surviving lane matches sequential.
        np.testing.assert_array_equal(np.asarray(win.ref_y[1]),
                                      np.asarray(seq.ref_y[1]))
        np.testing.assert_array_equal(np.asarray(win.ref_y[0]),
                                      np.asarray(seq.ref_y[0]))

    def test_window_overflow_repair(self):
        """Mid-window ST_TAPE_OVERFLOW corrupts the lane's remaining window
        frames (the intra-window reference moved on), and
        resolve_window_overflows replays the whole window host-side from
        the kept pre-window planes."""
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(870 + i, n=4) for i in range(2)]
        lists = [[streams[i][t] for i in range(2)] for t in range(4)]
        win = DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="ragged",
                                    tape_len=8)
        host = BatchedStreamDecoder(2, 48, 32, SORENSON)
        win.decode_steps(lists)
        status = np.asarray(win.last_status_steps)
        assert (status == df.ST_TAPE_OVERFLOW).any()
        repaired = win.resolve_window_overflows(status)
        assert repaired == [0, 1]
        for t in range(4):
            yh, cbh, crh = host.decode_step(lists[t])
        np.testing.assert_array_equal(np.asarray(win.ref_y), np.asarray(yh))
        np.testing.assert_array_equal(np.asarray(win.ref_cb), np.asarray(cbh))
        np.testing.assert_array_equal(np.asarray(win.ref_cr), np.asarray(crh))

    def test_window_requires_ragged(self):
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="rows")
        with pytest.raises(ValueError):
            dec.decode_steps([[None, None]])

    def test_single_step_invalidates_window_state(self):
        """ADVICE r4: a decode_step after a decode_steps window advances the
        reference planes past the pre-window snapshot; a later
        resolve_window_overflows must be a no-op, not a silent replay of
        the stale window over the advanced refs."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(890 + i, n=4) for i in range(2)]
        lists = [[streams[i][t] for i in range(2)] for t in range(4)]
        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="ragged",
                                    tape_len=8)  # tiny tape -> overflows
        dec.decode_steps(lists[:3])
        assert (np.asarray(dec.last_status_steps)
                == df.ST_TAPE_OVERFLOW).any()
        dec.decode_step(lists[3])
        assert dec._last_window is None and dec.last_status_steps is None
        before = np.asarray(dec.ref_y)
        assert dec.resolve_window_overflows() == []
        np.testing.assert_array_equal(np.asarray(dec.ref_y), before)

    def test_resolve_overflows_delegates_to_window(self):
        """ADVICE r4: after decode_steps, the generic resolve_overflows
        contract (StreamPool calls it) must repair MID-window overflows
        too — it delegates to resolve_window_overflows while a window is
        pending."""
        from h263_tpu.parallel.batch import BatchedStreamDecoder
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(910 + i, n=4) for i in range(2)]
        lists = [[streams[i][t] for i in range(2)] for t in range(4)]
        win = DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="ragged",
                                    tape_len=8)
        host = BatchedStreamDecoder(2, 48, 32, SORENSON)
        win.decode_steps(lists)
        status = np.asarray(win.last_status_steps)
        assert (status == df.ST_TAPE_OVERFLOW).any()
        # Mid-window overflows exist even where the final frame is clean:
        # the generic entry point must still repair those lanes.
        repaired = win.resolve_overflows()
        assert repaired == [0, 1]
        for t in range(4):
            yh, _, _ = host.decode_step(lists[t])
        np.testing.assert_array_equal(np.asarray(win.ref_y), np.asarray(yh))

    def test_reset_slot_clears_window_eligibility(self):
        """ADVICE r4: a recycled slot's lane must not be replayed from the
        departed occupant's window by a later resolve_window_overflows."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(930 + i, n=4) for i in range(2)]
        lists = [[streams[i][t] for i in range(2)] for t in range(4)]
        dec = DeviceFrontendDecoder(2, 48, 32, SORENSON, payload="ragged",
                                    tape_len=8)
        dec.decode_steps(lists)
        assert (np.asarray(dec.last_status_steps)
                == df.ST_TAPE_OVERFLOW).any()
        dec.reset_slot_state(0)
        zero = np.asarray(dec.ref_y[0])
        assert not zero.any()
        repaired = dec.resolve_window_overflows()
        assert 0 not in repaired
        np.testing.assert_array_equal(np.asarray(dec.ref_y[0]), zero)

    def test_window_buffer_reuse_smaller_second_window(self):
        """ADVICE r4: a big window followed by a smaller one on the SAME
        (T, bucket) staging key must not leak the first window's payload
        bytes past the second's end (whole-buffer zero-fill invariant)."""
        from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

        streams = [rich_gop(950 + i, n=4) for i in range(2)]
        lists = [[streams[i][t] for i in range(2)] for t in range(4)]
        win, seq = self._decoders(2)
        # Window 1: 2 frames of rich content (big payload).
        win.decode_steps(lists[:2])
        # Window 2, same T: absent lanes -> tiny skip-frame payloads; the
        # quantizer floors at 4096 so both windows share the bucket.
        ys, cbs, crs = win.decode_steps([[None, None], [None, None]])
        for t in range(2):
            seq.decode_step(lists[t])
        y, cb, cr = None, None, None
        for _ in range(2):
            y, cb, cr = seq.decode_step([None, None])
        np.testing.assert_array_equal(np.asarray(win.ref_y), np.asarray(y))
        np.testing.assert_array_equal(np.asarray(win.ref_cb), np.asarray(cb))
        np.testing.assert_array_equal(np.asarray(win.ref_cr), np.asarray(cr))
        assert (np.asarray(win.last_status) == 0).all()
