"""Property-based tests (hypothesis).

The reference declared hypothesis as a dev dependency but shipped zero
property tests (SURVEY.md §4); these pin the algebraic invariants the
system rests on.
"""
import numpy as np
from hypothesis import given, settings, strategies as st

from echoseal_tpu.core.crypto import SecureChannel
from echoseal_tpu.core.sequences import header_bits, header_bits_batch
from echoseal_tpu.ops.polar import (
    crc8_bits,
    encode_np,
    polar_spec,
    polar_transform_np,
)

KEY = bytes.fromhex("aa" * 32)
SEC = SecureChannel(KEY)


@settings(max_examples=25, deadline=None)
@given(st.binary(min_size=55, max_size=55))
def test_polar_transform_is_involutive(payload):
    """The GF(2) butterfly is its own inverse: decode(encode(u)) == u."""
    cw = encode_np(payload)
    spec = polar_spec()
    u = polar_transform_np(cw[None])[0]          # transform is involutive
    data = u[spec.data_pos]
    assert np.packbits(data[: spec.info_len]).tobytes() == payload
    np.testing.assert_array_equal(data[spec.info_len :],
                                  crc8_bits(data[: spec.info_len]))


@settings(max_examples=25, deadline=None)
@given(st.binary(min_size=1, max_size=64))
def test_aead_seal_open_roundtrip(plaintext):
    assert SEC.open(SEC.seal(plaintext)) == plaintext


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1),
       st.integers(min_value=1, max_value=2048))
def test_pn_prefix_consistency(ctr, n):
    """Shorter PN requests are prefixes of longer ones (CTR stream)."""
    a = SEC.pn_bits(ctr, n)
    b = SEC.pn_bits(ctr, n + 64)
    np.testing.assert_array_equal(a, b[:n])


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_header_bits_scalar_batch_agree(ctr):
    np.testing.assert_array_equal(
        header_bits(ctr), header_bits_batch(np.array([ctr]))[0])


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_slice_windows_matches_numpy(seed):
    """Window extraction equals numpy slicing, including the start clamp.

    ``demod.slice_windows`` is the production formulation (slice-granular
    gather rows, not a per-sample index-lattice gather); its
    contract is plain ``x[s : s + span]`` with starts clamped to
    ``[0, T - span]``, for both the (T,) and (B, T) source layouts.
    """
    import jax.numpy as jnp

    from echoseal_tpu.ops import demod

    rng = np.random.default_rng(seed)
    B, T, span = 3, 257, 31
    x = rng.standard_normal((B, T)).astype(np.float32)
    # starts deliberately include out-of-range values to pin the clamp
    starts = rng.integers(-10, T + 10, size=(B, 2, 4)).astype(np.int32)
    got = np.asarray(demod.slice_windows(jnp.asarray(x),
                                         jnp.asarray(starts), span))
    clamped = np.clip(starts, 0, T - span)
    for b in range(B):
        for i in range(2):
            for k in range(4):
                s = clamped[b, i, k]
                np.testing.assert_array_equal(got[b, i, k], x[b, s : s + span])
    # 1-D source path
    got1 = np.asarray(demod.slice_windows(jnp.asarray(x[0]),
                                          jnp.asarray(starts[0]), span))
    for i in range(2):
        for k in range(4):
            s = clamped[0, i, k]
            np.testing.assert_array_equal(got1[i, k], x[0, s : s + span])


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_host_fetch_roundtrip(seed):
    """host_fetch returns every leaf bit-exactly (f32 bitcast, bool, i32).

    The helper exists because each separate device->host download pays
    the thin link's round-trip latency; its contract is a lossless
    single-buffer fetch of a mixed-dtype pytree.
    """
    import jax.numpy as jnp

    from echoseal_tpu.utils.transfer import host_fetch

    rng = np.random.default_rng(seed)
    tree = {
        "f": jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32)),
        "i": jnp.asarray(rng.integers(-2**31, 2**31 - 1, size=(2, 7),
                                      dtype=np.int64).astype(np.int32)),
        "b": jnp.asarray(rng.integers(0, 2, size=(4,)).astype(bool)),
        "scalar": jnp.float32(rng.standard_normal()),
    }
    out = host_fetch(tree)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(tree[k]))
        assert out[k].dtype == np.asarray(tree[k]).dtype


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=2, max_value=40),
       st.integers(min_value=2, max_value=40),
       st.integers(min_value=0, max_value=2**31))
def test_device_resample_matches_scipy(up, down, seed):
    """ops/resample.py == scipy.signal.resample_poly for random rationals.

    The device resampler's whole contract is scipy parity (same FIR,
    same trim) at any rational ratio -- the enumerated-family tests in
    test_resample.py pin the serving ratios; this sweeps the space.
    Compile cost stays bounded because each (up, down, T) family shares
    one jit specialization and T is fixed here.
    """
    from math import gcd

    import jax.numpy as jnp
    from scipy.signal import resample_poly

    from echoseal_tpu.ops.resample import resample_rows

    if up == down:
        up += 1
    g = gcd(up, down)
    up, down = up // g, down // g
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    got = np.asarray(resample_rows(jnp.asarray(x), up, down))
    ref = resample_poly(x.astype(np.float64), up, down, axis=-1)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-9)
    assert float(np.abs(got - ref).max()) / scale < 2e-5
