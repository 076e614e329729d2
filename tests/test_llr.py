"""``ops.demod.payload_llr``: the despread + moment-normalised LLR chain."""
import jax.numpy as jnp
import numpy as np
import pytest

from echoseal_tpu.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_tpu.ops.demod import payload_llr

OFF = PRE_L + HDR_L


def llr_np(chips: np.ndarray, pn: np.ndarray, clip: float = 16.0):
    """Float64 NumPy re-derivation of the LLR chain, row by row."""
    z = chips[..., OFF:].astype(np.float64) * pn
    zn = z / np.sqrt(np.mean(z * z, axis=-1, keepdims=True) + 1e-20)
    amp = np.clip(np.mean(np.abs(zn), axis=-1, keepdims=True), 0.05, 1.0)
    sigma2 = np.maximum(1.0 - amp * amp, 0.05)
    return np.clip(2.0 * amp * zn / sigma2, -clip, clip)


def _inputs(rng, lead, scale=0.3, bias=0.2):
    chips = (rng.standard_normal(lead + (FRAME_LEN,)) * scale
             + bias).astype(np.float32)
    pn = (2.0 * rng.integers(0, 2, lead + (1024,)) - 1.0).astype(np.float32)
    return chips, pn


@pytest.mark.parametrize("lead", [(13,), (2, 4, 2), (1, 4, 2, 4)])
def test_payload_llr_matches_numpy(rng, lead):
    chips, pn = _inputs(rng, lead)
    got = np.asarray(payload_llr(jnp.asarray(chips), jnp.asarray(pn)))
    assert got.shape == lead + (1024,)
    np.testing.assert_allclose(got, llr_np(chips, pn), rtol=1e-4, atol=1e-4)


def test_payload_llr_rows_independent(rng):
    """Padding a batch with extra rows leaves every real row unchanged."""
    chips, pn = _inputs(rng, (5,))
    pad_c, pad_p = _inputs(rng, (11,), scale=3.0, bias=-1.0)
    alone = np.asarray(payload_llr(jnp.asarray(chips), jnp.asarray(pn)))
    padded = np.asarray(payload_llr(
        jnp.asarray(np.concatenate([chips, pad_c])),
        jnp.asarray(np.concatenate([pn, pad_p]))))
    np.testing.assert_array_equal(padded[:5], alone)
    zero = np.asarray(payload_llr(jnp.zeros((2, FRAME_LEN)),
                                  jnp.ones((2, 1024))))
    np.testing.assert_array_equal(zero, 0.0)


@pytest.mark.parametrize("clip", [16.0, 3.0])
def test_payload_llr_clip_bounds(rng, clip):
    """Noise-free chips saturate exactly at +-clip (sigma^2 floor 0.05)."""
    bits = rng.integers(0, 2, (3, 1024))
    pn = (2.0 * rng.integers(0, 2, (3, 1024)) - 1.0).astype(np.float32)
    chips = np.zeros((3, FRAME_LEN), np.float32)
    chips[:, OFF:] = 50.0 * (2.0 * bits - 1.0) * pn
    got = np.asarray(payload_llr(jnp.asarray(chips), jnp.asarray(pn),
                                 clip=clip))
    np.testing.assert_array_equal(np.abs(got), clip)


def test_payload_llr_sign_convention(rng):
    """Positive LLR favours bit 1: despread chip sign = +1 <=> bit 1."""
    bits = rng.integers(0, 2, (4, 1024))
    pn = (2.0 * rng.integers(0, 2, (4, 1024)) - 1.0).astype(np.float32)
    chips = np.zeros((4, FRAME_LEN), np.float32)
    noise = 0.2 * rng.standard_normal((4, 1024))
    chips[:, OFF:] = ((2.0 * bits - 1.0) + noise) * pn
    got = np.asarray(payload_llr(jnp.asarray(chips), jnp.asarray(pn)))
    np.testing.assert_array_equal(got > 0, bits == 1)
