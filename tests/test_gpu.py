"""Checks only the card can run (marker `gpu`; they skip elsewhere).
Run them on a GPU machine with

    H263_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu
"""

import os

import numpy as np
import pytest

from h263_tpu import DecoderOption

pytestmark = pytest.mark.gpu
SORENSON = DecoderOption.SORENSON_SPARK_BITSTREAM


def test_no_cpu_test_flags(gpu_device):
    flags = os.environ.get("XLA_FLAGS", "")
    assert "xla_disable_hlo_passes" not in flags
    assert "xla_force_host_platform_device_count" not in flags


def test_plain_idct_is_strict(gpu_device):
    """XLA:GPU rounds every f32 product: the plain IDCT equals the golden
    on every class and on the adversarial FMA block."""
    import jax

    from h263_tpu.ops.idct import golden_idct_dense, idct_residual_dense_jnp

    r = np.random.default_rng(0)
    d = np.where(r.random((4096, 64)) < 0.3,
                 r.integers(-2048, 2048, (4096, 64)), 0).astype(np.int16)
    d[0] = 0
    d[0, 2], d[0, 3], d[0, 18] = 735, -555, 215
    got = np.asarray(jax.jit(idct_residual_dense_jnp)(d))
    np.testing.assert_array_equal(got, golden_idct_dense(d))
    assert got[0].reshape(8, 8)[0, 2] == 28


@pytest.mark.parametrize("frontend", ["host", "device"])
def test_strict_gate(gpu_device, frontend):
    import bench
    from h263_tpu.parallel.batch import BatchedStreamDecoder
    from h263_tpu.parallel.device_batch import DeviceFrontendDecoder

    cls = BatchedStreamDecoder if frontend == "host" else DeviceFrontendDecoder
    bench.verify_strict_rounding(cls(4, 176, 144, SORENSON), 176, 144)
