"""Device-mesh sharding for batched multi-stream decode.

Streams are independent, so the only sharded axis is `stream`; every tensor
in the reconstruction program carries it as the leading dimension.  With
NamedSharding over a 1-D mesh, XLA compiles one SPMD program per chip with
zero inter-device communication.
"""

from __future__ import annotations

import functools


def make_stream_mesh(devices=None):
    """A 1-D mesh over all (or the given) devices, axis name 'stream'."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), ("stream",))


def shard_reconstruct_fn(mesh, h: int, w: int, packed=False, mv_full=False):
    """A jitted, stream-sharded batched reconstruction program.

    All inputs/outputs are sharded on their leading stream axis; the batch
    size must be divisible by the mesh size.  packed=True/"u32" shards the
    combined-u32 packed transport program, packed="split" the large-picture
    split transport (int32 positions + int16 values), packed="d24f" the
    fused single-leaf transport (the production default — `mv_full`
    selects the slim/full MV row layout), False the dense one.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..decoder.reconstruct import (
        reconstruct_frame_batched,
        reconstruct_frame_packed_d24,
        reconstruct_frame_packed_d24_fused,
        reconstruct_frame_packed_split,
        reconstruct_frame_packed_u32,
    )

    stream_sharding = NamedSharding(mesh, P("stream"))
    if packed == "split":
        fn = reconstruct_frame_packed_split
        n_in = 7
    elif packed == "d24f":
        fn = functools.partial(
            reconstruct_frame_packed_d24_fused, mv_full=mv_full,
            mbh=-(-h // 16), mbw=-(-w // 16))
        n_in = 4
    elif packed == "d24":
        fn = reconstruct_frame_packed_d24
        n_in = 6
    elif packed is True or packed == "u32":
        fn = reconstruct_frame_packed_u32
        n_in = 6
    elif packed is False or packed is None:
        fn, n_in = reconstruct_frame_batched, 11
    else:
        raise ValueError(
            f"packed must be False, True/'u32', 'split', 'd24', or "
            f"'d24f'; got {packed!r}")
    return jax.jit(
        fn,
        in_shardings=(stream_sharding,) * n_in,
        out_shardings=(stream_sharding,) * 3,
    )


def shard_device_frontend_fn(mesh, h: int, w: int, tape_len: int,
                             harness="xla", unroll: int = 4):
    """A jitted, stream-sharded device-front-end step program.

    The raw-bytes-in, planes-out step (parallel/device_batch.py): payload
    words -> lockstep VLC automaton -> tape scatters -> dense tensors ->
    reconstruction.  Every input/output (including the uint8 payload leaf
    and the int32 meta vectors) is sharded on the stream axis, so each
    device entropy-decodes only its own streams — the parse itself scales
    over the mesh, unlike the host front-end where the parse is a
    host-side serial stage.

    The step runs under shard_map, so each device's automaton loop stops
    when ITS lanes are done.  Partitioned by jit alone, the loop's
    any-lane-still-running predicate becomes an all-reduce across the
    mesh on every iteration.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .device_batch import make_whole_step

    spec = P("stream")
    stream_sharding = NamedSharding(mesh, spec)
    step = jax.shard_map(make_whole_step(h, w, tape_len, harness, unroll),
                         mesh=mesh, in_specs=(spec,) * 9,
                         out_specs=(spec,) * 4, check_vma=False)
    return jax.jit(
        step,
        in_shardings=(stream_sharding,) * 9,
        out_shardings=(stream_sharding,) * 4,
    )


def shard_present_fn(mesh):
    """A jitted, stream-sharded presentation program (deblock + BT.601).

    Inputs: y [S,H,W], cb/cr [S,ch,cw], strength int32 [S], apply bool [S];
    output RGBA uint8 [S,H,W,4].  Sharded on the stream axis like the
    reconstruction program — the full production step (reconstruct +
    present) runs collective-free on a multi-chip mesh.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..decoder.reconstruct import present_rgba_batched

    stream_sharding = NamedSharding(mesh, P("stream"))
    return jax.jit(
        present_rgba_batched,
        in_shardings=(stream_sharding,) * 5,
        out_shardings=stream_sharding,
    )
