"""SCL decoder proof at the shipped default list size (VERDICT r1 item 2).

The full measured operating curve (ours vs the reference engine at
L in {8, 32, 256}, sigma in [0.1, 1.0]) lives in benchmarks/scl_sweep.py
(generated by benchmarks/scl_sweep.py).  These tests pin the two facts a
CI run must keep true:

* the list decoder at the shipped default L=256 (RxParams.list_size,
  mirroring rtwm/detector.py:27) decodes strictly more frames than L=8 in
  the waterfall region -- i.e. the big-list path is real, not dead config;
* the full detector actually reaches ``stage == "scl"``: noise past the
  hard-decision (refined-chip) tolerance is rescued by the soft pass over
  the RAW least-squares chips.
"""
from __future__ import annotations

import numpy as np
import pytest

from echoseal_tpu.ops.polar import encode_np, polar_spec
from echoseal_tpu.ops.scl import scl_decode

FS = 48_000


def _successes(llr: np.ndarray, payloads, list_size: int) -> np.ndarray:
    import jax.numpy as jnp

    out = scl_decode(jnp.asarray(llr), polar_spec(), list_size)
    ok = np.asarray(out["crc_ok"])
    info = np.asarray(out["info_bits"])
    res = []
    for i, p in enumerate(payloads):
        hits = np.flatnonzero(ok[i])
        res.append(bool(hits.size) and np.packbits(
            info[i, hits[0]].astype(np.uint8)).tobytes() == p)
    return np.asarray(res)


def test_list_gain_at_shipped_default_256():
    """L=256 decodes frames L=8 cannot (waterfall sigma=0.38, pinned rng)."""
    spec = polar_spec()
    rng = np.random.default_rng(4242)
    payloads = [rng.bytes(55) for _ in range(24)]
    bits = np.stack([encode_np(p, spec) for p in payloads])
    sigma = 0.38
    y = (2.0 * bits - 1.0) + sigma * np.random.default_rng(
        777).standard_normal(bits.shape)
    llr = (2.0 * y / (sigma * sigma)).astype(np.float32)

    s8 = _successes(llr, payloads, 8)
    s256 = _successes(llr, payloads, 256)
    assert s256.sum() > s8.sum()
    assert np.any(s256 & ~s8)
    # measured on this seed: L8 decodes 1/24, L256 decodes 5/24
    assert s256.sum() >= 3


def test_detector_reaches_scl_stage():
    """AWGN past the hard-decision tolerance is rescued by the SCL stage.

    The v2 (robust) verifier is where the list decoder earns its keep:
    measured on silence-host clips, the hard path holds to ~+10 dB
    watermark SNR and stage 'scl' carries verification from +8 dB all the
    way to 0 dB (both seeds, CPU 1- and 8-device envs).  +4 dB sits mid-
    window, far from both boundaries.

    (The compat profile cannot host this test: its exact LS inversion
    amplifies f32 wire quantisation into a few confidently-wrong chips per
    frame, so its hard/soft boundary moves with platform rounding --
    measured flipping between 1- and 8-device CPU runs.)
    """
    from echoseal_tpu.models.robust import RobustEmbedder, RobustVerifier

    key = bytes.fromhex("aa" * 32)
    tx = RobustEmbedder(key)
    wm = tx.process(np.zeros(4 * FS, np.float32))
    wm_rms = float(np.sqrt(np.mean(wm * wm)))

    for seed in (1, 2):
        noise = np.random.default_rng(seed).standard_normal(
            wm.size).astype(np.float32)
        noisy = wm + wm_rms * 10.0 ** (-4.0 / 20.0) * noise
        r = RobustVerifier(key).verify_detailed(noisy, FS)
        assert r.authentic
        assert r.stage == "scl"


@pytest.mark.parametrize("which_spec", ["compat", "v2"])
def test_scl_implementations_parity(which_spec):
    """All four SCL formulations agree (ADVICE r2 / round-3 blocked+unrolled).

    ``_scl_decode_dense`` is the direct transcription of the list-decode
    recursion (eager full-state gathers, the oracle); ``_scl_decode_lazy``
    is the index-map/traceback rewrite (pinned for the CPU suite);
    ``_scl_decode_blocked`` is the two-level blocked scan (the library
    default);
    ``_scl_decode_unrolled`` is the statically-unrolled fast-list
    formulation (frozen leaves skip the fork,
    aligned rate-0 / repetition subtrees collapse to exact node-level
    shortcuts).  A systemic deviation in the shared fork logic would have
    no other detector, so this pins: identical sorted metrics and the
    identical SET of CRC-passing payloads, over noisy LLRs at two list
    sizes -- on BOTH specs (the v2 standard-convention info set contains
    the repetition subtrees the compat spec lacks).
    """
    import jax.numpy as jnp

    from echoseal_tpu.core.profiles import ROBUST, profile_spec
    from echoseal_tpu.ops.polar import pack_info_bits
    from echoseal_tpu.ops.scl import (
        _scl_decode_blocked,
        _scl_decode_dense,
        _scl_decode_lazy,
        _scl_decode_unrolled,
    )

    spec = polar_spec() if which_spec == "compat" else profile_spec(ROBUST)
    rng = np.random.default_rng(99)
    payloads = [rng.bytes(55) for _ in range(4)]
    bits = np.stack([encode_np(p, spec) for p in payloads])
    sigma = 0.45  # waterfall: paths genuinely fork and prune
    y = (2.0 * bits - 1.0) + sigma * rng.standard_normal(bits.shape)
    llr = jnp.asarray((2.0 * y / (sigma * sigma)).astype(np.float32))

    for L in (8, 32):
        oracle = _scl_decode_dense(llr, spec, L)
        mo = np.sort(np.asarray(oracle["metrics"]), axis=-1)
        so = [{pack_info_bits(r) for r in np.asarray(
            oracle["info_bits"][i])[np.asarray(oracle["crc_ok"][i])]}
            for i in range(len(payloads))]
        for impl in (_scl_decode_lazy, _scl_decode_blocked,
                     _scl_decode_unrolled):
            a = impl(llr, spec, L)
            ma = np.sort(np.asarray(a["metrics"]), axis=-1)
            np.testing.assert_allclose(ma, mo, rtol=1e-4, atol=1e-3)
            for i in range(len(payloads)):
                sa = {pack_info_bits(r) for r in np.asarray(
                    a["info_bits"][i])[np.asarray(a["crc_ok"][i])]}
                assert sa == so[i], (impl.__name__, L, i)


@pytest.mark.parametrize("which_spec", ["compat", "v2"])
def test_serving_scl_noiseless_exact(which_spec):
    """Serving (fast-SSCL) mode: noiseless codewords decode exactly.

    The non-parity throughput decoder (VERDICT r4 next #4) must return
    the transmitted payload with metric 0 on clean LLRs at every list
    size the ladder uses -- including L=1 (pure fast-SC: rate-1 / SPC
    hard paths with no forks at all) and the v2 spec, whose node mix
    (17 rate-0 / 18 rate-1 / 25 SPC / 25 rep at block_seg=16) covers
    every shortcut branch.
    """
    import jax.numpy as jnp

    from echoseal_tpu.core.profiles import ROBUST, profile_spec
    from echoseal_tpu.ops.scl import _scl_decode_unrolled

    spec = polar_spec() if which_spec == "compat" else profile_spec(ROBUST)
    rng = np.random.default_rng(7)
    payloads = [rng.bytes(55) for _ in range(4)]
    bits = np.stack([encode_np(p, spec) for p in payloads])
    llr = jnp.asarray((8.0 * (2.0 * bits - 1.0)).astype(np.float32))
    for L in (1, 8):
        out = _scl_decode_unrolled(llr, spec, L, serving=True)
        ok = np.asarray(out["crc_ok"])
        info = np.asarray(out["info_bits"])
        met = np.asarray(out["metrics"])
        for i, p in enumerate(payloads):
            assert ok[i, 0], (which_spec, L, i)
            assert np.packbits(
                info[i, 0].astype(np.uint8)).tobytes() == p
            assert met[i, 0] == 0.0


@pytest.mark.parametrize("which_spec", ["compat", "v2"])
def test_serving_scl_waterfall_fer(which_spec):
    """Serving FER tracks the exact decoder inside the operating envelope.

    Pinned-seed waterfall batch: the fast-SSCL mode (min-sum + hard
    metric + capped node forks) may lose individual borderline frames
    vs the exact decoder, but across the batch it must decode at least
    as many frames minus a small deterministic slack -- the full
    measured curve lives in benchmarks/scl_sweep.py (serving rows).
    """
    import jax.numpy as jnp

    from echoseal_tpu.core.profiles import ROBUST, profile_spec
    from echoseal_tpu.ops.scl import _scl_decode_lazy, _scl_decode_unrolled

    spec = polar_spec() if which_spec == "compat" else profile_spec(ROBUST)
    rng = np.random.default_rng(4242)
    payloads = [rng.bytes(55) for _ in range(24)]
    bits = np.stack([encode_np(p, spec) for p in payloads])
    sigma = 0.35
    y = (2.0 * bits - 1.0) + sigma * np.random.default_rng(
        31).standard_normal(bits.shape)
    llr = jnp.asarray((2.0 * y / (sigma * sigma)).astype(np.float32))

    def n_decoded(out):
        ok = np.asarray(out["crc_ok"])
        info = np.asarray(out["info_bits"])
        n = 0
        for i, p in enumerate(payloads):
            hits = np.flatnonzero(ok[i])
            n += bool(hits.size) and np.packbits(
                info[i, hits[0]].astype(np.uint8)).tobytes() == p
        return n

    n_exact = n_decoded(_scl_decode_lazy(llr, spec, 8))
    n_serving = n_decoded(_scl_decode_unrolled(llr, spec, 8, serving=True))
    assert n_serving >= n_exact - 2, (n_serving, n_exact)
    assert n_serving >= 1


def test_scl_serving_env_override(monkeypatch):
    """ECHOSEAL_SCL_IMPL forces the ladder entry onto a parity decoder."""
    import jax.numpy as jnp

    from echoseal_tpu.ops.scl import _scl_decode_lazy, scl_decode_serving

    spec = polar_spec()
    rng = np.random.default_rng(5)
    payloads = [rng.bytes(55) for _ in range(2)]
    bits = np.stack([encode_np(p, spec) for p in payloads])
    y = (2.0 * bits - 1.0) + 0.4 * rng.standard_normal(bits.shape)
    llr = jnp.asarray((2.0 * y / 0.16).astype(np.float32))

    monkeypatch.setenv("ECHOSEAL_SCL_IMPL", "lazy")
    forced = scl_decode_serving(llr, spec, 8)
    oracle = _scl_decode_lazy(llr, spec, 8)
    np.testing.assert_array_equal(np.asarray(forced["crc_ok"]),
                                  np.asarray(oracle["crc_ok"]))
    np.testing.assert_allclose(np.asarray(forced["metrics"]),
                               np.asarray(oracle["metrics"]))
