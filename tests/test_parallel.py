"""Multi-stream batching and device-mesh sharding tests (8 virtual CPU devices)."""

import numpy as np
import pytest

from h263_tpu import DecoderOption, H263Decoder, H263Error, PictureTypeCode
from h263_tpu.parallel import BatchedStreamDecoder, make_stream_mesh, shard_reconstruct_fn
from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def _stream_frames(seed: int, width=32, height=32, n_p=3):
    """One I-frame + n_p P-frames, content varying per seed."""
    rng = np.random.default_rng(seed)
    mbw, mbh = width // 16, height // 16
    mbs = []
    for _ in range(mbw * mbh):
        dc = int(rng.integers(1, 128)) * 8
        mbs.append(MBSpec(kind="intra", intradc=[dc] * 6,
                          blocks=[[(0, int(rng.integers(1, 12)))], [], [], [], [], []]))
    frames = [encode_sorenson_picture(width, height, PictureTypeCode.I_FRAME,
                                      mbs, temporal_reference=0)]
    for tr in range(1, n_p + 1):
        pmbs = []
        for _ in range(mbw * mbh):
            mvd = (int(rng.integers(-3, 4)) * 2, int(rng.integers(-3, 4)) * 2)
            pmbs.append(MBSpec(kind="inter", mvd=[mvd],
                               blocks=[[(0, int(rng.integers(1, 5)))], [], [], [], [], []]))
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME, pmbs, temporal_reference=tr))
    return frames


class TestBatchedDecoder:
    def test_matches_single_stream_decoders(self):
        n = 4
        per_stream = [_stream_frames(seed) for seed in range(n)]
        batched = BatchedStreamDecoder(n, 32, 32, SORENSON)
        singles = [H263Decoder(SORENSON, backend="numpy") for _ in range(n)]

        for t in range(len(per_stream[0])):
            y, cb, cr = batched.decode_step([per_stream[i][t] for i in range(n)])
            y, cb, cr = np.asarray(y), np.asarray(cb), np.asarray(cr)
            for i in range(n):
                pic = singles[i].decode_next_picture(per_stream[i][t])
                np.testing.assert_array_equal(y[i], pic.as_luma(),
                                              err_msg=f"stream {i} frame {t}")
                np.testing.assert_array_equal(cb[i], pic.as_chroma_b())
                np.testing.assert_array_equal(cr[i], pic.as_chroma_r())


class TestSharding:
    def test_mesh_sharded_reconstruction(self):
        import jax

        n_dev = len(jax.devices())
        assert n_dev == 8, "conftest should provide 8 virtual CPU devices"
        mesh = make_stream_mesh()
        fn = shard_reconstruct_fn(mesh, 32, 32)
        # The fused d24 single-leaf transport is the decoder's production
        # default; inject its sharded programs (both MV row layouts) plus
        # the legacy d24 program (varied-MV flip step fallback).
        pfn = shard_reconstruct_fn(mesh, 32, 32, packed="d24")
        ffns = {m: shard_reconstruct_fn(mesh, 32, 32, packed="d24f",
                                        mv_full=m) for m in (False, True)}

        n = 8
        per_stream = [_stream_frames(seed, n_p=2) for seed in range(n)]
        batched = BatchedStreamDecoder(n, 32, 32, SORENSON, reconstruct_fn=fn,
                                       packed_reconstruct_fn=pfn,
                                       fused_reconstruct_fns=ffns)
        singles = [H263Decoder(SORENSON, backend="numpy") for _ in range(n)]
        for t in range(3):
            y, cb, cr = batched.decode_step([per_stream[i][t] for i in range(n)])
            assert len(y.sharding.device_set) == 8
            y = np.asarray(y)
            for i in range(n):
                pic = singles[i].decode_next_picture(per_stream[i][t])
                np.testing.assert_array_equal(y[i], pic.as_luma())


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import importlib

        ge = importlib.import_module("__graft_entry__")
        import jax

        fn, args = ge.entry()
        y, cb, cr = jax.jit(fn)(*args)
        assert y.shape == (4, 288, 352)

    def test_dryrun_multichip(self):
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import importlib

        ge = importlib.import_module("__graft_entry__")
        ge.dryrun_multichip(8)


class TestPackedTransport:
    def test_packed_matches_dense(self):
        n = 4
        per_stream = [_stream_frames(seed, n_p=3) for seed in range(n)]
        dec_p = BatchedStreamDecoder(n, 32, 32, SORENSON)
        dec_d = BatchedStreamDecoder(n, 32, 32, SORENSON)
        for t in range(len(per_stream[0])):
            bufs = [per_stream[i][t] for i in range(n)]
            yp, cbp, crp = dec_p.decode_step(bufs, transport="packed")
            yd, cbd, crd = dec_d.decode_step(bufs, transport="dense")
            np.testing.assert_array_equal(np.asarray(yp), np.asarray(yd))
            np.testing.assert_array_equal(np.asarray(cbp), np.asarray(cbd))
            np.testing.assert_array_equal(np.asarray(crp), np.asarray(crd))

    def test_overflow_falls_back_to_dense(self):
        n = 2
        per_stream = [_stream_frames(seed, n_p=1) for seed in range(n)]
        dec = BatchedStreamDecoder(n, 32, 32, SORENSON, pack_cap=4)
        dec_ref = BatchedStreamDecoder(n, 32, 32, SORENSON)
        for t in range(2):
            bufs = [per_stream[i][t] for i in range(n)]
            y1, _, _ = dec.decode_step(bufs, transport="auto")
            y2, _, _ = dec_ref.decode_step(bufs, transport="dense")
            np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))

    def test_derive_classes_matches_host(self):
        import jax.numpy as jnp
        from h263_tpu.ops.idct import derive_classes_jnp
        from h263_tpu.bitio import BitReader
        from h263_tpu.parser import decode_picture
        from h263_tpu.parser.frame import parse_frame

        buf = _stream_frames(3, n_p=0)[0]
        r = BitReader(buf)
        pic = decode_picture(r, SORENSON, None)
        f = parse_frame(r, pic, SORENSON, pic.options, 32, 32)
        dense = f.coeffs_y.reshape(-1, 64)
        got = np.asarray(derive_classes_jnp(jnp.asarray(dense)))
        np.testing.assert_array_equal(got, f.class_y.reshape(-1))


class TestPresentation:
    def test_device_rgba_matches_golden(self):
        from h263_tpu.ops.deblock import QUANT_TO_STRENGTH, golden_deblock
        from h263_tpu.ops.yuv import golden_yuv420_to_rgba

        n = 4
        per_stream = [_stream_frames(seed, n_p=2) for seed in range(n)]
        dec = BatchedStreamDecoder(n, 32, 32, SORENSON)
        for t in range(3):
            dec.decode_step([per_stream[i][t] for i in range(n)])
        for force in (False, True):
            rgba = np.asarray(dec.present_rgba(deblock=force))
            y = np.asarray(dec.ref_y)
            cb = np.asarray(dec.ref_cb)
            cr = np.asarray(dec.ref_cr)
            for i in range(n):
                yi, cbi, cri = y[i], cb[i], cr[i]
                if force:
                    s = int(QUANT_TO_STRENGTH[dec.states[i].last_header.quantizer & 31])
                    if s > 0:
                        yi = golden_deblock(yi, s)
                        cbi = golden_deblock(cbi, s)
                        cri = golden_deblock(cri, s)
                want = golden_yuv420_to_rgba(yi, cbi, cri)
                np.testing.assert_array_equal(rgba[i], want, err_msg=f"s{i}")


class TestPipelined:
    def test_pipelined_matches_sequential(self):
        n = 4
        per_stream = [_stream_frames(seed, n_p=4) for seed in range(n)]
        seq = BatchedStreamDecoder(n, 32, 32, SORENSON)
        pipe = BatchedStreamDecoder(n, 32, 32, SORENSON)
        frames = [[per_stream[i][t] for i in range(n)]
                  for t in range(len(per_stream[0]))]
        seq_out = [np.asarray(seq.decode_step(b)[0]) for b in frames]
        pipe_out = [np.asarray(y) for (y, cb, cr)
                    in pipe.decode_stream_pipelined(iter(frames))]
        assert len(pipe_out) == len(seq_out)
        for a, b in zip(seq_out, pipe_out):
            np.testing.assert_array_equal(a, b)


class TestLargeFormats:
    def test_720p_uses_dense_transport(self):
        """1280x720 exceeds the u32 packed transport's 20-bit positions;
        decode_step must route to the split packed transport
        transparently (was: dense fallback)."""
        nmb = 80 * 45
        f0 = encode_sorenson_picture(
            1280, 720, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[800] * 6)] * nmb,
            temporal_reference=0)
        dec = BatchedStreamDecoder(1, 1280, 720, SORENSON)
        ref = H263Decoder(SORENSON, backend="numpy")
        y, cb, cr = dec.decode_step([f0])
        pic = ref.decode_next_picture(f0)
        np.testing.assert_array_equal(np.asarray(y)[0], pic.as_luma())


class TestStandardH263Batched:
    def test_standard_streams_batched(self):
        """Non-Sorenson streams decode batched (packed transport when the
        native front-end is present, dense otherwise) and match the
        single-stream decoder exactly."""
        from h263_tpu.testing.encoder import encode_standard_picture
        from h263_tpu.types import DecoderOption

        nmb = 8 * 6
        f0 = encode_standard_picture(
            128, 96, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[800] * 6)] * nmb)
        f1 = encode_standard_picture(
            128, 96, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, 0)],
                    blocks=[[(0, 4)], [], [], [], [], []])] * nmb,
            temporal_reference=1)
        dec = BatchedStreamDecoder(2, 128, 96, DecoderOption.NONE)
        dense = BatchedStreamDecoder(2, 128, 96, DecoderOption.NONE)
        ref = H263Decoder(DecoderOption.NONE, backend="numpy")
        for f in (f0, f1):
            y, cb, cr = dec.decode_step([f, f])
            yd, cbd, crd = dense.decode_step([f, f], transport="dense")
            pic = ref.decode_next_picture(f)
            np.testing.assert_array_equal(np.asarray(y)[0], pic.as_luma())
            np.testing.assert_array_equal(np.asarray(cb)[1], pic.as_chroma_b())
            np.testing.assert_array_equal(np.asarray(y), np.asarray(yd))
            np.testing.assert_array_equal(np.asarray(cr), np.asarray(crd))


class TestTracing:
    def test_stage_metrics(self):
        from h263_tpu.utils.trace import (
            get_metrics, reset_metrics, trace_enabled, trace_stage)

        reset_metrics()
        trace_enabled(True)
        try:
            per = [_stream_frames(s, n_p=1) for s in range(2)]
            dec = BatchedStreamDecoder(2, 32, 32, SORENSON)
            for t in range(2):
                dec.decode_step([per[0][t], per[1][t]])
            m = get_metrics()
            assert m["host_parse"]["count"] == 2
            assert m["transfer"]["count"] == 2
            assert m["reconstruct_dispatch"]["count"] == 2
            assert m["host_parse"]["total_s"] > 0
            assert 0 < m["host_parse"]["min_ms"] <= m["host_parse"]["max_ms"]
        finally:
            trace_enabled(False)
            reset_metrics()

    def test_event_counters_always_on(self):
        """Counters record without tracing enabled: frames, steps, bytes."""
        from h263_tpu.utils.trace import get_counters, reset_metrics

        reset_metrics()
        try:
            per = [_stream_frames(s, n_p=2) for s in range(2)]
            dec = BatchedStreamDecoder(2, 32, 32, SORENSON)
            for t in range(3):
                dec.decode_step([per[0][t], per[1][t]])
            c = get_counters()
            assert c["frames_decoded"] == 6
            assert c["steps"] == 3
            assert c["transfer_bytes"] > 0
        finally:
            reset_metrics()

    def test_pool_churn_counters(self):
        from h263_tpu.parallel.pool import StreamPool
        from h263_tpu.utils.trace import get_counters, reset_metrics

        reset_metrics()
        try:
            frames = _stream_frames(3, n_p=2)
            pool = StreamPool(SORENSON)
            pool.add_stream("a", 32, 32)
            pool.add_stream("b", 32, 32)
            pool.decode_step({"a": frames[0], "b": frames[0]})
            pool.remove_stream("b")
            pool.decode_step({"a": frames[1]})
            c = get_counters()
            assert c["pool_joins"] == 2
            assert c["pool_leaves"] == 1
        finally:
            reset_metrics()


class TestSplitPackedTransport:
    """Pictures too large for 20-bit combined-u32 positions (> ~2730 MBs)
    ride the split transport (int32 pos + int16 val) — same results as the
    dense transport, bit for bit."""

    def _corpus(self):
        from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
        W, H, mbw, mbh = 1280, 720, 80, 45
        rng = np.random.default_rng(5)
        mbs_i = [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6,
                        blocks=[[(0, 4)], [], [], [(2, -6)], [], []])
                 for _ in range(mbw * mbh)]
        i_f = encode_sorenson_picture(W, H, PictureTypeCode.I_FRAME, mbs_i,
                                      quantizer=7)
        mbs_p = [MBSpec(kind="inter", mvd=[(3, -1)],
                        blocks=[[(0, 9)], [], [], [], [], []]
                        if k % 5 == 0 else [[], [], [], [], [], []])
                 for k in range(mbw * mbh)]
        p_f = encode_sorenson_picture(W, H, PictureTypeCode.P_FRAME, mbs_p,
                                      quantizer=7, temporal_reference=1)
        return W, H, [i_f, p_f]

    def test_720p_split_equals_dense(self):
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        W, H, corpus = self._corpus()
        S = 2
        d1 = BatchedStreamDecoder(S, W, H, coef_transport="split")
        assert d1._split
        outs_split = [np.asarray(a) for f in corpus
                      for a in d1.decode_step([f] * S)]
        d2 = BatchedStreamDecoder(S, W, H)
        outs_dense = [np.asarray(a) for f in corpus
                      for a in d2.decode_step([f] * S, transport="dense")]
        for a, b in zip(outs_split, outs_dense):
            np.testing.assert_array_equal(a, b)

    def test_split_transport_sharded(self):
        """The split-transport program compiles and runs over a stream
        mesh, matching the unsharded program exactly (CIF-sized inputs so
        the 8-device CPU mesh stays fast; routing at real >2730-MB sizes is
        covered by test_720p_split_equals_dense)."""
        import jax
        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device mesh")
        from h263_tpu.decoder.reconstruct import (
            reconstruct_frame_packed_split)
        S, H, W = 8, 144, 176
        mbh, mbw = 9, 11
        nco = 6 * mbh * mbw * 64
        rng = np.random.default_rng(11)
        K = 40
        pos = rng.integers(0, nco, size=(S, K)).astype(np.int32)
        pos[:, -5:] = nco  # sentinel padding entries must drop
        val = rng.integers(-200, 200, size=(S, K)).astype(np.int16)
        mvs = rng.integers(-8, 8, size=(S, mbh, mbw, 4, 2)).astype(np.int16)
        inter = (rng.random((S, mbh, mbw)) < 0.5).astype(np.uint8)
        ref = rng.integers(0, 255, size=(S, H, W)).astype(np.uint8)
        refc = rng.integers(0, 255, size=(S, H // 2, W // 2)).astype(np.uint8)
        mesh = make_stream_mesh()
        fn = shard_reconstruct_fn(mesh, H, W, packed="split")
        a = fn(pos, val, mvs, inter, ref, refc, refc)
        b = reconstruct_frame_packed_split(pos, val, mvs, inter,
                                           ref, refc, refc)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_split_pack_overflow_falls_back_to_dense(self):
        """PackOverflow on the split transport replays on the dense path
        with no state corruption (atomic native failure)."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        W, H, corpus = self._corpus()
        S = 2
        dec = BatchedStreamDecoder(S, W, H, pack_cap=8,  # absurdly small
                                   coef_transport="split")
        assert dec._split
        y1 = np.asarray(dec.decode_step([corpus[0]] * S)[0])
        ref = BatchedStreamDecoder(S, W, H)
        y2 = np.asarray(ref.decode_step([corpus[0]] * S, transport="dense")[0])
        np.testing.assert_array_equal(y1, y2)


class TestShardedPresent:
    def test_present_sharded_matches_unsharded(self):
        """The presentation program (deblock + BT.601) sharded over the
        stream mesh is bit-identical to the unsharded program."""
        import jax
        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device mesh")
        from h263_tpu.decoder.reconstruct import present_rgba_batched
        from h263_tpu.parallel import make_stream_mesh, shard_present_fn

        S, H, W = 8, 48, 48
        rng = np.random.default_rng(21)
        y = rng.integers(0, 255, (S, H, W)).astype(np.uint8)
        cb = rng.integers(0, 255, (S, H // 2, W // 2)).astype(np.uint8)
        cr = rng.integers(0, 255, (S, H // 2, W // 2)).astype(np.uint8)
        strength = rng.integers(1, 13, S).astype(np.int32)
        apply = rng.random(S) < 0.7

        fn = shard_present_fn(make_stream_mesh())
        a = np.asarray(fn(y, cb, cr, strength, apply))
        b = np.asarray(present_rgba_batched(
            jax.numpy.asarray(y), jax.numpy.asarray(cb),
            jax.numpy.asarray(cr), jax.numpy.asarray(strength),
            jax.numpy.asarray(apply)))
        np.testing.assert_array_equal(a, b)

    def test_packed_u32_sharded(self):
        """The stream-sharded packed-u32 program matches the unsharded one
        over the mesh."""
        import jax
        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device mesh")
        from h263_tpu.decoder.reconstruct import reconstruct_frame_packed_u32
        from h263_tpu.parallel import make_stream_mesh, shard_reconstruct_fn

        S, H, W = 8, 48, 48
        mbh = mbw = 3
        nco = 6 * mbh * mbw * 64
        rng = np.random.default_rng(22)
        K = 32
        pos = rng.integers(0, nco, (S, K)).astype(np.int64)
        val = rng.integers(-1024, 1024, (S, K)).astype(np.int64)
        u32 = ((pos << 12) | (val & 0xFFF)).astype(np.int32)
        u32[:, -4:] = np.int32(nco << 12)  # sentinel padding
        mvs = rng.integers(-6, 6, (S, mbh, mbw, 4, 2)).astype(np.int16)
        inter = (rng.random((S, mbh, mbw)) < 0.5).astype(np.uint8)
        ref = rng.integers(0, 255, (S, H, W)).astype(np.uint8)
        refc = rng.integers(0, 255, (S, H // 2, W // 2)).astype(np.uint8)

        mesh = make_stream_mesh()
        fn = shard_reconstruct_fn(mesh, H, W, packed=True)
        a = fn(u32, mvs, inter, ref, refc, refc)
        b = reconstruct_frame_packed_u32(u32, mvs, inter, ref, refc, refc)
        for x, yv in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(yv))


class TestStandardNativeBatch:
    """The standard-H.263 one-FFI-call batch path (native PTYPE headers)
    must match the Python-header path bit-exactly, and fall back to it for
    header shapes outside the fast path."""

    def _gop(self, seed, w=128, h=96, n=4, umv=False):
        from h263_tpu.testing.encoder import encode_standard_picture

        rng = np.random.default_rng(seed)
        nmb = (w // 16) * (h // 16)
        frames = [encode_standard_picture(
            w, h, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6)
             for _ in range(nmb)], temporal_reference=0, umv=umv)]
        for tr in range(1, n):
            frames.append(encode_standard_picture(
                w, h, PictureTypeCode.P_FRAME,
                [MBSpec(kind="inter",
                        mvd=[(int(rng.integers(-4, 5)) * 2,
                              int(rng.integers(-4, 5)))],
                        blocks=[[(0, int(rng.integers(1, 7)))], [], [],
                                [(1, -3)], [], []])
                 for _ in range(nmb)], temporal_reference=tr, umv=umv))
        return frames

    def test_native_matches_python_headers(self):
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        from h263_tpu.native.bindings import NeedsPythonHeader

        streams = [self._gop(40 + i) for i in range(3)]
        fast = BatchedStreamDecoder(3, 128, 96, DecoderOption.NONE)
        slow = BatchedStreamDecoder(3, 128, 96, DecoderOption.NONE)
        # Force the reference decoder down the Python-header path.
        slow._parse_std_native = lambda *a, **k: (_ for _ in ()).throw(
            NeedsPythonHeader(-1))
        for t in range(4):
            bufs = [streams[i][t] for i in range(3)]
            ya = np.asarray(fast.decode_step(bufs)[0])
            yb = np.asarray(slow.decode_step(bufs)[0])
            np.testing.assert_array_equal(ya, yb, err_msg=f"frame {t}")
        # Committed header state must agree too.
        for a, b in zip(fast.states, slow.states):
            assert a.running_options == b.running_options
            assert a.has_reference == b.has_reference
            assert a.last_header.temporal_reference == b.last_header.temporal_reference
            assert a.last_header.quantizer == b.last_header.quantizer
            assert a.last_header.picture_type == b.last_header.picture_type
            assert a.last_header.format.width_and_height() == \
                b.last_header.format.width_and_height()
        # vs single-stream decoder for ground truth
        ref = H263Decoder(DecoderOption.NONE, backend="numpy")
        for t in range(4):
            pic = ref.decode_next_picture(streams[0][t])
        np.testing.assert_array_equal(
            np.asarray(fast.ref_y)[0], pic.as_luma())

    def test_plusptype_falls_back_to_python(self):
        """A PLUSPTYPE (custom-format) stream punts the batch to the Python
        header path with identical results."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        # 160x128 is not a CIF-family size -> encoder must use PLUSPTYPE?
        # encode_standard_picture requires CIF family; use the PTYPE GOP but
        # spike one stream with a hand-built PLUSPTYPE header instead.
        from h263_tpu.testing.encoder import BitWriter, encode_macroblock

        w_pix, h_pix = 128, 96
        nmb = (w_pix // 16) * (h_pix // 16)

        def plusptype_iframe():
            w = BitWriter()
            w.write_bits(1, 17)
            w.write_bits(0, 5)
            w.write_bits(0, 8)
            w.write_code("10000")
            w.write_code("111")          # PLUSPTYPE
            w.write_code("001")          # UFEP
            w.write_code("110")          # custom format
            w.write_bits(0, 1)
            w.write_bits(0, 1)
            w.write_bits(0, 9)
            w.write_code("1000")
            w.write_code("000")
            w.write_code("000")
            w.write_code("001")
            w.write_bits(0, 1)           # CPM
            w.write_bits(0b0001, 4)      # CPFMT: square PAR
            w.write_bits(w_pix // 4 - 1, 9)
            w.write_bits(1, 1)
            w.write_bits(h_pix // 4, 9)
            w.write_bits(9, 5)           # PQUANT
            w.write_bits(0, 1)           # PEI
            for _ in range(nmb):
                encode_macroblock(w, MBSpec(kind="intra", intradc=[800] * 6),
                                  PictureTypeCode.I_FRAME, None)
            return w.to_bytes()

        ptype_stream = self._gop(50)
        bufs0 = [plusptype_iframe(), ptype_stream[0]]
        dec = BatchedStreamDecoder(2, 128, 96, DecoderOption.NONE)
        y, _, _ = dec.decode_step(bufs0)
        # stream 0 went through the Python path: PLUSPTYPE header recorded
        assert dec.states[0].last_header.has_plusptype
        assert not dec.states[1].last_header.has_plusptype
        assert dec._std_prev_fmt[0] == -2  # non-PTYPE: quirk punts next step
        assert dec._std_prev_fmt[1] == 1   # SQCIF

        ref = H263Decoder(DecoderOption.NONE, backend="numpy")
        pic = ref.decode_next_picture(bufs0[0])
        np.testing.assert_array_equal(np.asarray(y)[0], pic.as_luma())

    def test_umv_carry_forward_quirk(self):
        """A plain-PTYPE picture's own UMV bit is discarded; the running
        UMV carries (state.rs:147-155).  Native and Python paths agree."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        streams = [self._gop(60, umv=True)]
        dec = BatchedStreamDecoder(1, 128, 96, DecoderOption.NONE)
        for t in range(2):
            dec.decode_step([streams[0][t]])
        from h263_tpu.types import PictureOption
        # header carries the bit...
        assert dec.states[0].last_header.options & \
            PictureOption.UNRESTRICTED_MOTION_VECTORS
        # ...but running options dropped it (nothing PLUSPTYPE carried it in)
        assert not (dec.states[0].running_options &
                    PictureOption.UNRESTRICTED_MOTION_VECTORS)
        ref = H263Decoder(DecoderOption.NONE, backend="numpy")
        for t in range(2):
            pic = ref.decode_next_picture(streams[0][t])
        np.testing.assert_array_equal(np.asarray(dec.ref_y)[0], pic.as_luma())


class TestDelta24Transport:
    """The delta-coded 3-byte coefficient transport must match the u32 and
    dense transports bit-exactly, including advance-escapes over long
    uncoded gaps and the zigzag-overflow block-discard rewind."""

    def _decode_all(self, frames, S, W, H, **kw):
        dec = BatchedStreamDecoder(S, W, H, **kw)
        outs = []
        for f in frames:
            outs.extend(np.asarray(a) for a in dec.decode_step([f] * S))
        return outs, dec

    def _gop(self, seed=9, w=96, h=64, sparse_tail=True):
        rng = np.random.default_rng(seed)
        nmb = (w // 16) * (h // 16)
        frames = [encode_sorenson_picture(
            w, h, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                    blocks=[[(0, 7), (3, -2)], [], [(1, 4)], [], [], []])
             for _ in range(nmb)], temporal_reference=0)]
        # P-frame with ONE coded MB at the end: the ordinal gap spans
        # ~ nmb*384 units and forces a run of 4095-advance escapes.
        mbs = [MBSpec(kind="uncoded")] * (nmb - 1) + [
            MBSpec(kind="inter", mvd=[(2, -2)],
                   blocks=[[(0, 5)], [], [], [], [], [(2, -6)]])]
        frames.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME, mbs, temporal_reference=1))
        # Dense-ish P-frame.
        frames.append(encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(0, 2)],
                    blocks=[[(0, int(rng.integers(1, 9)))], [], [], [], [], []])
             for _ in range(nmb)], temporal_reference=2))
        return frames

    def test_d24_equals_u32_and_dense(self):
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        frames = self._gop()
        a, da = self._decode_all(frames, 2, 96, 64, coef_transport="d24")
        b, _ = self._decode_all(frames, 2, 96, 64, coef_transport="u32")
        c, _ = self._decode_all(frames, 2, 96, 64)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        assert da.coef_transport == "d24"

    def test_d24_discard_block_quirk(self):
        """Zigzag overflow discards the whole block; the d24 cursor rewinds
        with the pack cursor (native emit rewind)."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        # run 62 from zz=1 (intra) lands at 63; a second coefficient
        # overflows -> whole block discarded (rle.rs:125-127).
        mbs = [MBSpec(kind="intra", intradc=[800] * 6,
                      blocks=[[(62, 5), (0, 3)], [(0, 4)], [], [], [], []])]
        mbs += [MBSpec(kind="intra", intradc=[640] * 6)] * 3
        f = encode_sorenson_picture(32, 32, PictureTypeCode.I_FRAME, mbs)
        a, _ = self._decode_all([f], 1, 32, 32, coef_transport="d24")
        b, _ = self._decode_all([f], 1, 32, 32, coef_transport="u32")
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_d24_large_picture_equals_split(self):
        """d24 has no 20-bit position limit: 720p decodes identically to
        the split transport."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        W, H, nmb = 1280, 720, 80 * 45
        rng = np.random.default_rng(12)
        f0 = encode_sorenson_picture(
            W, H, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[int(rng.integers(1, 120)) * 8] * 6)
             for _ in range(nmb)], quantizer=7)
        f1 = encode_sorenson_picture(
            W, H, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(1, -3)],
                    blocks=[[(0, 8)], [], [], [], [], []]
                    if k % 11 == 0 else [[], [], [], [], [], []])
             for k in range(nmb)], quantizer=7, temporal_reference=1)
        a, dd = self._decode_all([f0, f1], 1, W, H, coef_transport="d24")
        b, ds = self._decode_all([f0, f1], 1, W, H, coef_transport="split")
        assert ds._split and not dd._split
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_d24_standard_h263(self):
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        from h263_tpu.testing.encoder import encode_standard_picture

        nmb = 8 * 6
        frames = [encode_standard_picture(
            128, 96, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[720] * 6)] * nmb),
            encode_standard_picture(
            128, 96, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, -1)],
                    blocks=[[(0, 4)], [], [], [], [], []])] * nmb,
            temporal_reference=1)]
        a, _ = self._decode_all(frames, 2, 128, 96,
                                decoder_options=DecoderOption.NONE,
                                coef_transport="d24")
        b, _ = self._decode_all(frames, 2, 128, 96,
                                decoder_options=DecoderOption.NONE)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


class TestHostBufferReuseSafety:
    """The transport hands reused ping-pong host buffers to jax.device_put,
    which may read them asynchronously (GPU) or alias them outright (CPU
    zero-copy).  Reusing a buffer before the consuming step executed
    corrupted that step's input — observed as nondeterministic decodes
    whenever several steps queued up behind a slow compile with no
    intervening readback (regression: round 2).  The decoder must block on
    a buffer's consuming step before recycling it."""

    def test_no_readback_run_matches_per_step_readback(self):
        frames = _stream_frames(11, n_p=7)
        n = 3

        def run(readback_each_step):
            dec = BatchedStreamDecoder(n, 32, 32, SORENSON)
            y = cb = cr = None
            for f in frames:
                y, cb, cr = dec.decode_step([f] * n)
                if readback_each_step:
                    np.asarray(y)
            return np.asarray(y), np.asarray(cb), np.asarray(cr)

        golden = run(readback_each_step=True)
        free_running = run(readback_each_step=False)
        for a, b in zip(golden, free_running):
            np.testing.assert_array_equal(a, b)

    def test_reuse_gate_is_set_and_cleared(self):
        frames = _stream_frames(12, n_p=3)
        dec = BatchedStreamDecoder(2, 32, 32, SORENSON)
        dec.decode_step([frames[0]] * 2)
        used = dec._packed[dec._packed_idx]
        assert used.in_flight is not None  # outputs gate the buffer
        dec.decode_step([frames[1]] * 2)
        dec.decode_step([frames[2]] * 2)  # recycles the first buffer
        assert used.in_flight is not None and used is dec._packed[dec._packed_idx]

    def test_pipelined_matches_sequential(self):
        frames = _stream_frames(13, n_p=9)
        n = 2
        dec_seq = BatchedStreamDecoder(n, 32, 32, SORENSON)
        golden = None
        for f in frames:
            golden = dec_seq.decode_step([f] * n)

        dec_pipe = BatchedStreamDecoder(n, 32, 32, SORENSON)
        last = None
        for last in dec_pipe.decode_stream_pipelined([f] * n for f in frames):
            pass
        for a, b in zip(golden, last):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestPipelineFailureRecovery:
    def test_failed_step_does_not_poison_its_buffer(self):
        """A step that raises on the pipeline worker delivers its exception
        to the submitter exactly once; two submits later the same ping-pong
        buffer must recycle cleanly instead of re-raising the stale
        exception forever (regression: round 2 review)."""
        frames = _stream_frames(21, n_p=6)
        n = 2
        dec = BatchedStreamDecoder(n, 32, 32, SORENSON)
        golden = BatchedStreamDecoder(n, 32, 32, SORENSON)

        real_fn = dec._packed_fn
        real_fused_fn = dec._fused_fn
        calls = {"n": 0}

        def _maybe_fail():
            calls["n"] += 1
            if calls["n"] == 2:  # fail the second step's device stage
                raise RuntimeError("transient device failure")

        def flaky(*args):
            _maybe_fail()
            return real_fn(*args)

        def flaky_fused(mv_full):
            inner = real_fused_fn(mv_full)

            def wrapped(*args):
                _maybe_fail()
                return inner(*args)

            return wrapped

        dec._packed_fn = flaky
        dec._fused_fn = flaky_fused
        fut0 = dec.submit_step([frames[0]] * n)
        fut1 = dec.submit_step([frames[1]] * n)
        np.asarray(fut0.result()[0])
        with pytest.raises(RuntimeError):
            fut1.result()

        # The decoder's reference state for frame 1 is lost (the failed
        # step never ran), so re-submit frame 1 and continue the GOP: every
        # later step must succeed and match a clean decoder.
        outs = [golden.decode_step([f] * n) for f in frames]
        for t in (1, 2, 3, 4):
            y, cb, cr = dec.submit_step([frames[t]] * n).result()
            np.testing.assert_array_equal(np.asarray(y),
                                          np.asarray(outs[t][0]),
                                          err_msg=f"frame {t} after recovery")


class TestBatchReviewFixes:
    """Regression tests for the r3-late high-effort review of batch.py."""

    def test_parse_one_packed_fills_slim_mvs(self):
        """The per-slot fast parser never writes mvs_slim natively; the
        Python wrapper must derive it or slim-mode steps motion-compensate
        with zero vectors."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")

        n, w, h = 1, 32, 32
        nmb = 4
        f0 = encode_sorenson_picture(
            w, h, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[400] * 6)] * nmb)
        f1 = encode_sorenson_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(4, 2)],
                    blocks=[[], [], [], [], [], []])] * nmb,
            temporal_reference=1)

        ref = H263Decoder(DecoderOption.SORENSON_SPARK_BITSTREAM,
                          backend="numpy")
        dec = BatchedStreamDecoder(n, w, h, coef_transport="u32")
        packed = dec.next_packed_batch()
        dec.parse_one_packed(0, f0, packed)
        dec.step_packed(packed)
        ref.decode_next_picture(f0)

        packed = dec.next_packed_batch()
        dec.parse_one_packed(0, f1, packed)
        assert not dec._mv_full  # uniform MVs: the slim path ships
        np.testing.assert_array_equal(packed.mvs_slim[0],
                                      packed.mvs[0, :, :, 0, :])
        assert packed.mvs_slim.any()  # real pan, not zeros
        y, _, _ = dec.step_packed(packed)
        pic = ref.decode_next_picture(f1)
        np.testing.assert_array_equal(np.asarray(y)[0], pic.as_luma())

    def test_u32_sentinel_pad_wraps_like_native(self):
        """>=1366-MB pictures shift the u32 sentinel past int32; the
        Python fallback loop must wrap exactly like entropy.cpp instead
        of raising OverflowError."""
        from h263_tpu.native import ensure_built
        if not ensure_built():
            pytest.skip("native front-end unavailable")
        from h263_tpu.testing.encoder import encode_standard_picture

        w, h = 704, 560  # custom format -> PLUSPTYPE -> Python fallback
        nmb = (w // 16) * (h // 16)
        assert 6 * nmb * 64 << 12 >= 1 << 31  # the overflowing regime
        f0 = encode_standard_picture(
            w, h, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[800] * 6)] * nmb)
        dec = BatchedStreamDecoder(1, w, h, DecoderOption.NONE,
                                   coef_transport="u32")
        packed = dec.next_packed_batch()
        dec.parse_batch_packed([f0], packed)  # raised OverflowError before
        count = int(packed.counts[0])
        assert count > 0
        tail = packed.u32[0, count:]
        if tail.size:
            expect = (6 * nmb * 64 << 12) & 0xFFFFFFFF
            assert (tail.astype(np.int64) & 0xFFFFFFFF == expect).all()

    def test_standard_custom_dims_and_skip_frame(self):
        """Custom-format standard buckets (PLUSPTYPE+CPFMT) decode and can
        pad absent slots (skip_frame_bytes used to KeyError outside the
        CIF family)."""
        from h263_tpu.testing.encoder import encode_standard_picture

        w, h = 64, 48
        nmb = (w // 16) * (h // 16)
        f0 = encode_standard_picture(
            w, h, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[640] * 6)] * nmb)
        f1 = encode_standard_picture(
            w, h, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(2, 0)],
                    blocks=[[(0, 4)], [], [], [], [], []])] * nmb,
            temporal_reference=1)
        ref = H263Decoder(DecoderOption.NONE, backend="numpy")
        dec = BatchedStreamDecoder(2, w, h, DecoderOption.NONE)
        y, _, _ = dec.decode_step([f0, f0])
        pic0 = ref.decode_next_picture(f0)
        np.testing.assert_array_equal(np.asarray(y)[0], pic0.as_luma())
        # Slot 1 absent: decodes the custom-dims skip frame, keeps planes.
        y, _, _ = dec.decode_step([f1, None],
                                  mask=np.array([True, False]))
        pic1 = ref.decode_next_picture(f1)
        np.testing.assert_array_equal(np.asarray(y)[0], pic1.as_luma())
        np.testing.assert_array_equal(np.asarray(y)[1], pic0.as_luma())

    def test_dense_path_commits_all_or_nothing(self):
        """One corrupt stream in a dense-path step must leave EVERY
        stream's header state untouched (the packed path's contract)."""
        frames = [encode_sorenson_picture(
            32, 32, PictureTypeCode.I_FRAME,
            [MBSpec(kind="intra", intradc=[800] * 6)] * 4)]
        dec = BatchedStreamDecoder(2, 32, 32)
        with pytest.raises(H263Error):
            dec.decode_step([frames[0], b"\x00" * 8], transport="dense")
        assert dec.states[0].last_header is None  # stream 0 NOT committed
        assert not dec.states[0].has_reference

    def test_decode_step_rejects_unknown_transport(self):
        dec = BatchedStreamDecoder(1, 32, 32)
        with pytest.raises(ValueError, match="transport"):
            dec.decode_step([b""], transport="d24")


def test_shard_reconstruct_fn_rejects_unknown_packed_mode():
    mesh = make_stream_mesh()
    with pytest.raises(ValueError, match="packed"):
        shard_reconstruct_fn(mesh, 32, 32, packed="d24F")
