"""Parity of host-side primitives vs reference golden vectors.

Golden fixtures in tests/golden/reference_vectors.npz were generated once
from the reference implementation (rtwm @ /root/reference) with key
0xAA * 32; these tests pin our crypto/PN/band-plan/sequence layers to the
wire format.
"""
from pathlib import Path

import numpy as np
import pytest

from echoseal_tpu.core.bandplan import BAND_PLAN, band_index, hop_schedule
from echoseal_tpu.core.crypto import SecureChannel
from echoseal_tpu.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_tpu.core.sequences import header_bits, header_bits_batch, mls63

GOLD = np.load(Path(__file__).parent / "golden" / "reference_vectors.npz")


@pytest.fixture(scope="module")
def sec(key32):
    return SecureChannel(key32)


def test_mls63_matches_reference():
    np.testing.assert_array_equal(mls63(), GOLD["mls63"])


def test_frame_constants():
    assert PRE_L == 63 and HDR_L == 128 and FRAME_LEN == 1215


def test_pn_bits_parity(sec):
    for ctr in (0, 1, 255, 1024, 65537):
        np.testing.assert_array_equal(sec.pn_bits(ctr, 1215), GOLD[f"pn_{ctr}"])


def test_pn_bits_batch_matches_scalar(sec):
    ctrs = np.array([0, 1, 255, 1024, 65537])
    batch = sec.pn_bits_batch(ctrs, 1215)
    for i, ctr in enumerate(ctrs):
        np.testing.assert_array_equal(batch[i], GOLD[f"pn_{ctr}"])


def test_header_pn_is_frame0_prefix(sec):
    np.testing.assert_array_equal(sec.pn_bits(0, 128), GOLD["hdr_pn"])


def test_band_plan_hop_parity(key32):
    idx = np.array([band_index(key32, c) for c in range(512)])
    np.testing.assert_array_equal(idx, GOLD["band_idx"])


def test_hop_schedule_counters_in_band(key32):
    sched = hop_schedule(key32)
    for b in range(len(BAND_PLAN)):
        ctrs = sched.counters_in_band(0, 512, b)
        assert all(GOLD["band_idx"][c] == b for c in ctrs)
    total = sum(
        sched.counters_in_band(0, 512, b).size for b in range(len(BAND_PLAN))
    )
    assert total == 512


def test_aead_roundtrip(sec):
    pt = bytes(range(27))
    blob = sec.seal(pt)
    assert len(blob) == 55
    assert sec.open(blob) == pt


def test_aead_opens_reference_blob(sec):
    blob = GOLD["sealed_blob"].tobytes()
    assert sec.open(blob) == GOLD["sealed_plain"].tobytes()


def test_aead_tamper_rejected(sec):
    blob = bytearray(sec.seal(bytes(range(27))))
    blob[20] ^= 1
    with pytest.raises(Exception):
        sec.open(bytes(blob))


def test_aead_wrong_key_rejected(sec):
    other = SecureChannel(bytes(32))
    with pytest.raises(Exception):
        other.open(sec.seal(bytes(range(27))))


def test_open_any_layout_front_and_tail(sec):
    blob = sec.seal(bytes(range(27)))
    pt, layout = sec.open_any_layout(blob)
    assert pt == bytes(range(27)) and layout == "nonce-front"
    tail = blob[12:] + blob[:12]
    pt, layout = sec.open_any_layout(tail)
    assert pt == bytes(range(27)) and layout == "nonce-tail"


def test_header_bits_layout():
    bits = header_bits(0xABCD)
    assert bits.size == HDR_L
    # MSB-first, repeated 8x
    first16 = bits.reshape(16, 8)[:, 0]
    expect = [(0xABCD >> (15 - i)) & 1 for i in range(16)]
    np.testing.assert_array_equal(first16, expect)
    np.testing.assert_array_equal(bits.reshape(16, 8).min(1),
                                  bits.reshape(16, 8).max(1))


def test_header_bits_batch_matches_scalar():
    ctrs = np.array([0, 1, 0xFFFF, 0x12345])
    batch = header_bits_batch(ctrs)
    for i, c in enumerate(ctrs):
        np.testing.assert_array_equal(batch[i], header_bits(int(c)))


def test_persistent_cache_key_ignores_platform_env(monkeypatch, tmp_path):
    """The compile cache sits where the outside can place it.

    ``JAX_COMPILATION_CACHE_DIR`` is honoured as given; unset, the cache
    is the fixed ``<repo>/.jax_cache`` (a per-``XLA_FLAGS`` subdirectory
    for the CPU feature hazard), independent of ``JAX_PLATFORMS`` and
    derived from no boot id, pid, time or ``/tmp``.
    """
    from echoseal_tpu.utils import cache

    repo_cache = Path(__file__).resolve().parents[1] / ".jax_cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    a = cache.persistent_cache_dir()
    monkeypatch.delenv("JAX_PLATFORMS")
    assert cache.persistent_cache_dir() == a == str(repo_cache)

    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    c = cache.persistent_cache_dir()
    assert Path(c).parent == repo_cache and c == cache.persistent_cache_dir()
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    assert cache.persistent_cache_dir() not in (a, c)

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.persistent_cache_dir() == str(tmp_path)
    assert cache.enable_persistent_cache() == str(tmp_path)
