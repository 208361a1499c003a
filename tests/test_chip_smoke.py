"""chip_smoke.py: its refusal to run without a GPU, its output contract,
and its comparison helpers at tiny shapes on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _run(script, cwd):
    return subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def _has_result(stdout):
    return any(line.startswith("{") for line in stdout.splitlines())


def test_fails_without_gpu():
    out = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not _has_result(out.stdout)


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = cs.result_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 400.00 W\n", "NVIDIA H100 80GB HBM3, 400.00 W"),
    ("\n  NVIDIA H100 80GB HBM3, 700.00 W  \nNVIDIA H100 80GB HBM3, 700.00 W\n",
     "NVIDIA H100 80GB HBM3, 700.00 W"),
])
def test_parse_nvidia_smi(text, want):
    assert cs.parse_nvidia_smi(text) == want


@pytest.mark.parametrize("text", ["", "\n\n", "No devices were found"])
def test_parse_nvidia_smi_rejects_garbage(text):
    with pytest.raises(RuntimeError):
        cs.parse_nvidia_smi(text)


@pytest.mark.parametrize("flags,bad", [
    ("", []),
    ("--xla_gpu_autotune_level=2", []),
    ("--xla_force_host_platform_device_count=8 "
     "--xla_disable_hlo_passes=fusion",
     ["xla_disable_hlo_passes", "xla_force_host_platform_device_count"]),
])
def test_cpu_test_flags_detected(flags, bad):
    assert cs.cpu_test_flags(flags) == bad


def test_assert_equal_reports_first_mismatch():
    a = np.zeros((3, 4), np.uint8)
    cs.assert_equal("same", a, a.copy())
    b = a.copy()
    b[1, 2] = 7
    with pytest.raises(AssertionError, match=r"1 of 12 .* at \(1, 2\)"):
        cs.assert_equal("plane", b, a)
    with pytest.raises(AssertionError, match="shape"):
        cs.assert_equal("plane", a, a[:2])


def test_sample_lanes_cover_corpora_and_far_end():
    lanes = cs.sample_lanes(2048, 8)
    assert {s % 8 for s in lanes} == set(range(8))
    assert 2047 in lanes and len(lanes) >= 8
    assert cs.sample_lanes(3, 8) == [0, 1, 2]


def test_fma_block_is_the_adversarial_block():
    from h263_tpu.ops.idct import golden_idct_dense

    assert golden_idct_dense(cs.fma_block()[None])[0].reshape(8, 8)[0, 2] == 28


def test_dense_from_frame_feeds_reconstruct_from_dense():
    """The dense layout chip_smoke builds is the one the device path
    reconstructs: an I-frame through reconstruct_from_dense equals the
    numpy decoder."""
    import jax.numpy as jnp

    from h263_tpu.bitio import BitReader
    from h263_tpu.decoder.reconstruct import reconstruct_from_dense
    from h263_tpu.parser.frame import parse_frame_auto
    from h263_tpu.parser.picture import decode_picture
    from h263_tpu.types import DecoderOption, PictureOption

    opts = DecoderOption.SORENSON_SPARK_BITSTREAM
    buf = cs.corpora(48, 32, 1, 1)[0][0]
    r = BitReader(buf)
    pic = decode_picture(r, opts, None)
    frame = parse_frame_auto(r, pic, opts, PictureOption.NONE, 48, 32)
    dense = cs.dense_from_frame(frame)
    assert dense.shape == (6 * 6, 64) and dense.dtype == np.int16
    zeros = lambda *s: jnp.zeros(s, jnp.uint8)  # noqa: E731
    y, cb, cr = reconstruct_from_dense(
        jnp.asarray(dense)[None], jnp.zeros((1, 2, 3, 4, 2), jnp.int16),
        jnp.zeros((1, 2, 3), bool), zeros(1, 32, 48), zeros(1, 16, 24),
        zeros(1, 16, 24))
    want = cs.numpy_decode([buf])[0]
    for got, w in zip((y, cb, cr), want[:3]):
        cs.assert_equal("I-frame", np.asarray(got)[0], w)


def test_golden_rgba_matches_device_present():
    import jax.numpy as jnp

    from h263_tpu.decoder.reconstruct import present_rgba_batched

    r = np.random.default_rng(3)
    y = r.integers(0, 256, (24, 40), dtype=np.uint8)
    cb = r.integers(0, 256, (12, 20), dtype=np.uint8)
    cr = r.integers(0, 256, (12, 20), dtype=np.uint8)
    for deblock in (False, True):
        got = present_rgba_batched(
            jnp.asarray(y)[None], jnp.asarray(cb)[None],
            jnp.asarray(cr)[None], jnp.asarray([9], jnp.int32),
            jnp.asarray([deblock]))
        from h263_tpu.ops.deblock import QUANT_TO_STRENGTH

        q = int(np.nonzero(QUANT_TO_STRENGTH == 9)[0][0])
        cs.assert_equal("rgba", np.asarray(got)[0],
                        cs.golden_rgba(y, cb, cr, q, deblock))


def test_idct_parity_tiny():
    """Phase 1's parity check at a tiny shape (the plain route on the CPU):
    every class present, equal to the golden."""
    corpus = cs.corpora(64, 48, 2, 3)
    counts = cs.idct_parity(corpus, 3, 64, 48)
    assert sum(counts.values()) == 3 * 6 * 12
    assert min(counts.values()) > 0


def test_numpy_decode_returns_planes_and_quantizer():
    out = cs.numpy_decode(cs.corpora(32, 32, 1, 2)[0])
    assert len(out) == 2
    y, cb, cr, q = out[1]
    assert y.shape == (32, 32) and cb.shape == (16, 16) and 1 <= q <= 31
