"""Long-GOP drift soak: a 60-frame P-chain amplifies any single-LSB
reconstruction divergence; all execution paths must agree bit-for-bit at
every frame."""

import numpy as np

from h263_tpu import DecoderOption, H263Decoder, PictureTypeCode
from h263_tpu.parallel import BatchedStreamDecoder
from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def _rich_gop(seed, width=48, height=48, n_frames=60):
    """I-frame then P-frames with dense, varied content: all sparsity
    classes, half-pel MVs in every combination, escapes, dquant churn,
    4V macroblocks, uncoded gaps."""
    rng = np.random.default_rng(seed)
    mbw, mbh = width // 16, height // 16
    nmb = mbw * mbh

    def blocks(n_heavy):
        out = []
        for b in range(6):
            if rng.random() < 0.35:
                out.append([])
                continue
            evs, total = [], 0
            for _ in range(int(rng.integers(1, n_heavy))):
                run = int(rng.integers(0, 10))
                if total + run + 1 > 64:
                    break
                lvl = int(rng.integers(1, 110)) * (1 if rng.random() < 0.5 else -1)
                evs.append((run, lvl))
                total += run + 1
            out.append(evs)
        return out

    frames = [encode_sorenson_picture(
        width, height, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra",
                intradc=[int(rng.integers(1, 128)) * 8 for _ in range(6)],
                blocks=blocks(6)) for _ in range(nmb)],
        quantizer=int(rng.integers(2, 20)), temporal_reference=0, version=1)]

    for tr in range(1, n_frames):
        mbs = []
        for _ in range(nmb):
            roll = rng.random()
            if roll < 0.15:
                mbs.append(MBSpec(kind="uncoded"))
            elif roll < 0.25:
                mbs.append(MBSpec(
                    kind="intra",
                    intradc=[int(rng.integers(1, 128)) * 8 for _ in range(6)],
                    blocks=blocks(4),
                    dquant=int(rng.choice([0, -1, 1]))))
            else:
                fourv = rng.random() < 0.25
                nmv = 4 if fourv else 1
                mvd = [(int(rng.integers(-10, 11)), int(rng.integers(-10, 11)))
                       for _ in range(nmv)]
                mbs.append(MBSpec(kind="inter", mvd=mvd, blocks=blocks(4),
                                  dquant=int(rng.choice([0, 0, -2, 2]))))
        frames.append(encode_sorenson_picture(
            width, height, PictureTypeCode.P_FRAME, mbs,
            quantizer=int(rng.integers(2, 20)), temporal_reference=tr & 0xFF,
            version=1))
    return frames


def test_60_frame_drift_all_paths():
    frames = _rich_gop(42)
    d_np = H263Decoder(SORENSON, backend="numpy")
    d_jx = H263Decoder(SORENSON, backend="jax")
    d_b = BatchedStreamDecoder(1, 48, 48, SORENSON)
    d_p = DeviceFrontendDecoder(1, 48, 48, SORENSON)

    for t, buf in enumerate(frames):
        pn = d_np.decode_next_picture(buf)
        pj = d_jx.decode_next_picture(buf)
        yb, cbb, crb = d_b.decode_step([buf])
        yp, cbp, crp = d_p.decode_step([buf])
        ref = pn.as_luma()
        np.testing.assert_array_equal(np.asarray(pj.as_luma()), ref,
                                      err_msg=f"jax drift at frame {t}")
        np.testing.assert_array_equal(np.asarray(yb)[0], ref,
                                      err_msg=f"batched drift at frame {t}")
        np.testing.assert_array_equal(np.asarray(yp)[0], ref,
                                      err_msg=f"devfe drift at frame {t}")
        np.testing.assert_array_equal(np.asarray(cbb)[0], pn.as_chroma_b(),
                                      err_msg=f"chroma drift at frame {t}")


def test_presentation_drift():
    """RGBA presentation (deblock + BT.601) after a 20-frame GOP must match
    the golden host path across device backends."""
    from h263_tpu.parallel import BatchedStreamDecoder
    from h263_tpu.ops.deblock import QUANT_TO_STRENGTH, golden_deblock
    from h263_tpu.ops.yuv import golden_yuv420_to_rgba

    frames = _rich_gop(7, n_frames=20)
    d_np = H263Decoder(SORENSON, backend="numpy")
    d_jx = H263Decoder(SORENSON, backend="jax")
    d_b = BatchedStreamDecoder(1, 48, 48, SORENSON)
    for buf in frames:
        d_np.decode_next_picture(buf)
        d_jx.decode_next_picture(buf)
        d_b.decode_step([buf])

    for force in (True, False):
        want = d_np.last_picture_rgba(force)
        np.testing.assert_array_equal(d_jx.last_picture_rgba(force), want)
        got_b = np.asarray(d_b.present_rgba(force))[0]
        np.testing.assert_array_equal(got_b, want)
