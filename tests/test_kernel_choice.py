"""The decoders' `pallas` kernel choice after the Mosaic kernels went:
"auto"/"off" select the one XLA program, the removed choices raise with
the reason, and checkpoint blobs that recorded them still resume."""

import numpy as np
import pytest

from h263_tpu import DecoderOption, PictureTypeCode
from h263_tpu.decoder.reconstruct import LEGACY_PALLAS, check_pallas
from h263_tpu.parallel import BatchedStreamDecoder
from h263_tpu.parallel.device_batch import DeviceFrontendDecoder
from h263_tpu.testing.encoder import MBSpec, encode_sorenson_picture
from h263_tpu.utils import checkpoint as ck

SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def _gop(seed, n=5):
    rng = np.random.default_rng(seed)
    frames = [encode_sorenson_picture(
        32, 32, PictureTypeCode.I_FRAME,
        [MBSpec(kind="intra", intradc=[int(rng.integers(1, 128)) * 8] * 6,
                blocks=[[(0, 3)], [], [], [], [], []])
         for _ in range(4)], temporal_reference=0)]
    for tr in range(1, n):
        frames.append(encode_sorenson_picture(
            32, 32, PictureTypeCode.P_FRAME,
            [MBSpec(kind="inter", mvd=[(int(rng.integers(-3, 4)), 1)],
                    blocks=[[(1, int(rng.integers(1, 6)))], [], [], [], [],
                            []])
             for _ in range(4)], temporal_reference=tr))
    return frames


def _with_meta(blob, **changes):
    """The blob with its JSON meta edited (as an older writer left it)."""
    meta, z = ck._unpack(blob)
    meta.update(changes)
    return ck._pack(meta, {k: z[k] for k in z.files if k != "meta"})


@pytest.mark.parametrize("choice", ["auto", "off"])
def test_plain_choices_accepted(choice):
    check_pallas(choice)
    dec = BatchedStreamDecoder(1, 32, 32, SORENSON, pallas=choice)
    assert not hasattr(dec, "pallas")


@pytest.mark.parametrize("choice", LEGACY_PALLAS)
@pytest.mark.parametrize("cls", [BatchedStreamDecoder, DeviceFrontendDecoder])
def test_removed_choices_raise_with_reason(cls, choice):
    with pytest.raises(ValueError, match="removed"):
        cls(1, 32, 32, SORENSON, pallas=choice)


def test_unknown_choice_raises():
    with pytest.raises(ValueError, match="'auto' or 'off'"):
        check_pallas("triton")


def test_drop_legacy_pallas_keeps_everything_else():
    kw = {"pallas": "tpu", "tape_len": 99}
    assert ck._drop_legacy_pallas(kw) == {"tape_len": 99}
    assert ck._drop_legacy_pallas({"pallas": "off"}) == {"pallas": "off"}
    assert kw == {"pallas": "tpu", "tape_len": 99}  # input untouched


@pytest.mark.parametrize("legacy", LEGACY_PALLAS)
def test_device_frontend_blob_with_legacy_choice_resumes(legacy):
    """A device-front-end blob that recorded a removed kernel choice loads
    and continues bit-exactly."""
    streams = [_gop(60), _gop(61)]
    ref = DeviceFrontendDecoder(2, 32, 32, SORENSON)
    dec = DeviceFrontendDecoder(2, 32, 32, SORENSON)
    for t in range(2):
        ref.decode_step([s[t] for s in streams])
        dec.decode_step([s[t] for s in streams])
    blob = _with_meta(ck.save_device_frontend_state(dec), pallas=legacy)
    resumed = ck.load_device_frontend_state(blob)
    for t in range(2, 5):
        ya, _, _ = ref.decode_step([s[t] for s in streams])
        yb, _, _ = resumed.decode_step([s[t] for s in streams])
        np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))


def test_pool_blob_with_legacy_choice_resumes():
    """Pool blobs store the decoder kwargs; a removed kernel choice there
    is dropped on load, for the pool and for its buckets."""
    from h263_tpu.parallel.pool import StreamPool

    gop = _gop(70)

    def build():
        pool = StreamPool()
        pool.add_stream("s", 32, 32)
        for t in range(2):
            pool.decode_step({"s": gop[t]})
        return pool

    ref = build()
    blob = _with_meta(ck.save_pool_state(build()),
                      decoder_kwargs={"pallas": "tpu"})
    resumed = ck.load_pool_state(blob)
    assert "pallas" not in resumed.decoder_kwargs
    for t in range(2, 5):
        ya = ref.decode_step({"s": gop[t]})["s"][0]
        yb = resumed.decode_step({"s": gop[t]})["s"][0]
        np.testing.assert_array_equal(ya, yb)


def test_new_blobs_record_no_kernel_choice():
    dec = DeviceFrontendDecoder(1, 32, 32, SORENSON)
    dec.decode_step([_gop(80)[0]])
    meta, _ = ck._unpack(ck.save_device_frontend_state(dec))
    assert "pallas" not in meta
