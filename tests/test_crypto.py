"""Known-answer tests of the in-repo crypto primitives (core/crypto.py).

Vectors are the standards' own: FIPS-197 App. C.1 (AES-128), RFC 8439
sec 2.3.2 / 2.5.2 / 2.8.2 (ChaCha20 block, Poly1305, AEAD) and RFC 5869
A.1 (HKDF-SHA256).  The wire-format golden tests (``pn_*``,
``sealed_blob``) live in tests/test_core.py.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from echoseal_tpu.core import crypto
from echoseal_tpu.core.crypto import SecureChannel

REPO = Path(__file__).resolve().parents[1]


def h(s: str) -> bytes:
    return bytes.fromhex(s.replace(" ", "").replace(":", "").replace("\n", ""))


def test_aes128_fips197_c1():
    rk = crypto.aes128_round_keys(bytes(range(16)))
    pt = np.frombuffer(h("00112233445566778899aabbccddeeff"), np.uint8)
    ct = crypto.aes128_encrypt_blocks(rk, pt[None])
    assert ct.tobytes() == h("69c4e0d86a7b0430d8cdb78070b4c55a")


def test_aes128_blocks_are_independent():
    """Vectorised ECB: a block's ciphertext does not depend on its batch."""
    rk = crypto.aes128_round_keys(bytes(range(16)))
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 256, (37, 16), dtype=np.uint8)
    batch = crypto.aes128_encrypt_blocks(rk, blocks)
    for i in (0, 17, 36):
        one = crypto.aes128_encrypt_blocks(rk, blocks[i:i + 1])
        np.testing.assert_array_equal(batch[i], one[0])


def test_chacha20_block_rfc8439():
    key = bytes(range(32))
    nonce = h("000000090000004a00000000")
    ks = crypto.chacha20_stream(key, np.frombuffer(nonce, np.uint8), 1, 1)
    assert ks[0].tobytes() == h(
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


def test_poly1305_rfc8439():
    key = h("85:d6:be:78:57:55:6d:33:7f:44:52:fe:42:d5:06:a8:"
            "01:03:80:8a:fb:0d:b2:fd:4a:bf:f6:af:41:49:f5:1b")
    tag = crypto.poly1305_mac(key, b"Cryptographic Forum Research Group")
    assert tag == h("a8:06:1d:c1:30:51:36:c6:c2:2b:8b:af:0c:01:27:a9")


AEAD_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
           b"only one tip for the future, sunscreen would be it.")
AEAD_KEY = bytes(range(0x80, 0xA0))
AEAD_NONCE = h("070000004041424344454647")
AEAD_AAD = h("50515253c0c1c2c3c4c5c6c7")
AEAD_CT = h("""
d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6
3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36
92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc
3ff4def08e4b7a9de576d26586cec64b6116""")
AEAD_TAG = h("1ae10b594f09e26a7e902ecbd0600691")


def test_aead_seal_and_open_rfc8439():
    aead = crypto.ChaCha20Poly1305(AEAD_KEY)
    sealed = aead.encrypt(AEAD_NONCE, AEAD_PT, AEAD_AAD)
    assert sealed == AEAD_CT + AEAD_TAG
    assert aead.decrypt(AEAD_NONCE, sealed, AEAD_AAD) == AEAD_PT


def test_hkdf_sha256_rfc5869_a1():
    okm = crypto.hkdf_sha256(b"\x0b" * 22, 42, salt=bytes(range(13)),
                             info=bytes(range(0xF0, 0xFA)))
    assert okm == h("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db0"
                    "2d56ecc4c5bf34007208d5b887185865")


@pytest.mark.parametrize("layout", ["nonce-front", "nonce-tail"])
def test_aead_rejects_tampered_tag(key32, layout):
    sec = SecureChannel(key32)
    blob = sec.seal(bytes(range(27)))
    if layout == "nonce-tail":
        blob = blob[12:] + blob[:12]
    assert sec.open_any_layout(blob) == (bytes(range(27)), layout)
    tag_end = len(blob) - (12 if layout == "nonce-tail" else 0)
    bad = bytearray(blob)
    bad[tag_end - 1] ^= 0x80                    # last tag byte
    assert sec.open_any_layout(bytes(bad)) == (None, None)
    if layout == "nonce-front":
        with pytest.raises(crypto.InvalidTag):
            sec.open(bytes(bad))


def test_open_any_layout_many_matches_single(key32):
    sec = SecureChannel(key32)
    rng = np.random.default_rng(7)
    blobs = []
    for i in range(9):
        b = sec.seal(bytes([i]) * 27)
        if i % 3 == 1:
            b = b[12:] + b[:12]                 # nonce-tail layout
        elif i % 3 == 2:
            b = rng.bytes(len(b))               # garbage: rejected
        blobs.append(b)
    many = sec.open_any_layout_many(
        np.frombuffer(b"".join(blobs), np.uint8).reshape(9, -1))
    assert many == [sec.open_any_layout(b) for b in blobs]
    assert [m[1] for m in many[:3]] == ["nonce-front", "nonce-tail", None]


def test_pn_batch_equals_per_counter(key32):
    sec = SecureChannel(key32)
    ctrs = np.array([0, 3, 65535, 65536, 1 << 33, (1 << 63) + 5],
                    dtype=np.uint64)
    batch = sec.pn_bits_batch(ctrs, 1215)
    for i, c in enumerate(ctrs):
        np.testing.assert_array_equal(batch[i], sec.pn_bits(int(c), 1215))


def test_verify_round_trip_without_cryptography_package():
    """The package imports and verifies with ``cryptography`` unimportable."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "cryptography" or name.startswith("cryptography."):
                    raise ImportError("cryptography is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import echoseal_tpu
        from echoseal_tpu.core.params import FRAME_LEN
        from echoseal_tpu.models.embedder import BatchEmbedder, db_to_lin

        key = bytes.fromhex("aa" * 32)
        be = BatchEmbedder(key)
        frames = be.frames(np.arange(6), session_nonce=b"nocrypto")
        clip = np.zeros((1, 8192), np.float32)
        clip[0, :6 * FRAME_LEN] = frames.reshape(-1) * db_to_lin(
            be.p.floor_rel_dbfs)
        bv = echoseal_tpu.BatchVerifier(key, max_ctr=64)
        ok = bv.finish_host(bv.run_device(clip), expected_nonce=b"nocrypto")
        assert "cryptography" not in sys.modules
        assert ok.tolist() == [True], ok
        print("ROUND_TRIP_OK")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "ROUND_TRIP_OK" in proc.stdout, (
        proc.stdout[-2000:] + proc.stderr[-2000:])
