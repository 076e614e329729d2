"""One-round-trip host fetch for pytrees of small device arrays.

Every separate ``np.asarray(device_array)`` pays a device-to-host round
trip (a synchronisation plus a transfer) no matter how small the array
is.  A stage that returns a dict of seven outputs therefore costs seven
round-trips if fetched naively (the arrays themselves total ~150 KB).
``host_fetch`` concatenates every leaf into one int32 buffer on device
(f32 leaves bitcast -- never value-converted -- so the round trip is
lossless; bool leaves widen to int32) and downloads it once.

The serving pipelines use purpose-built packed rows instead
(models/pipeline.py ``_pack_host_row``); this generic helper serves the
single-clip ladders where the output set varies by stage.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def host_fetch(tree):
    """Fetch a pytree of int32/float32/bool device arrays in ONE download."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    parts = []
    metas: list[tuple[np.dtype, tuple]] = []
    for a in leaves:
        dt = np.dtype(a.dtype)
        if dt == np.bool_:
            flat = a.astype(jnp.int32).reshape(-1)
        elif dt == np.float32:
            flat = jax.lax.bitcast_convert_type(a, jnp.int32).reshape(-1)
        elif dt == np.int32:
            flat = a.reshape(-1)
        else:
            raise TypeError(f"host_fetch supports int32/float32/bool "
                            f"leaves, got {dt}")
        parts.append(flat)
        metas.append((dt, tuple(a.shape)))
    buf = np.asarray(jnp.concatenate(parts)) if parts else np.zeros(0, np.int32)
    out = []
    off = 0
    for dt, shape in metas:
        n = math.prod(shape)
        seg = buf[off : off + n]
        off += n
        if dt == np.bool_:
            arr = seg.astype(bool).reshape(shape)
        elif dt == np.float32:
            arr = seg.view(np.float32).reshape(shape)
        else:
            arr = seg.reshape(shape)
        out.append(arr)
    return jax.tree_util.tree_unflatten(treedef, out)
