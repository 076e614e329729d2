"""Host-side crypto: key schedule, AEAD seal/open, AES-CTR PN keystream.

All crypto stays on the host CPU by design (SURVEY.md sec 7.1): PN bits and
band indices are *inputs* to the device programs, and AEAD verification
consumes their *outputs*.  This keeps the device code pure, static-shaped
and batchable.

Wire-compatible with the reference channel:

* HKDF-SHA256(info=b"EchoSeal:KDF:v1", 64 bytes) over the 32-byte master key
  -> aead_key (first 32) + prng_key (last 32)        (crypto.py:14-30)
* AEAD: IETF ChaCha20-Poly1305, 12-byte random nonce  (crypto.py:33-37)
* PN keystream: AES-128-ECB used as a CTR block function, sub-key =
  BLAKE2s(prng_key, digest_size=16, person=b"EchoSeal"); counter space per
  frame is ``(frame_ctr << 64) | block_idx`` as 16-byte big-endian blocks
  (utils.py:93-124); bytes -> bits MSB-first.

The primitives are implemented here over the standard library and NumPy
(HKDF via ``hmac``/``hashlib``, AES-128 per FIPS-197, ChaCha20-Poly1305
per RFC 8439) so the package needs no compiled crypto dependency.  AES and
ChaCha20 are vectorised over blocks: the verifier's PN table is ~164 k AES
blocks, encrypted as one array pass.  Known-answer tests from the
standards pin each primitive (tests/test_crypto.py).
"""
from __future__ import annotations

import hashlib
import hmac
import secrets

import numpy as np

_KDF_INFO = b"EchoSeal:KDF:v1"
_PN_PERSON = b"EchoSeal"


class InvalidTag(ValueError):
    """AEAD authentication failed (wrong key, tampered blob or layout)."""


# ======================================================================
# HKDF-SHA256 (RFC 5869)
# ======================================================================
def hkdf_sha256(ikm: bytes, length: int, salt: bytes | None = None,
                info: bytes = b"") -> bytes:
    """Extract-then-expand HKDF with SHA-256."""
    if length > 255 * 32:
        raise ValueError("HKDF-SHA256 output is limited to 8160 bytes")
    prk = hmac.new(salt or bytes(32), ikm, hashlib.sha256).digest()
    okm, t = b"", b""
    for i in range(1, -(-length // 32) + 1):
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
    return okm[:length]


def derive_subkeys(master_key: bytes) -> tuple[bytes, bytes]:
    """HKDF split of the master key into (aead_key, prng_key)."""
    if len(master_key) != 32:
        raise ValueError("master_key must be 32 bytes (256 bit)")
    okm = hkdf_sha256(master_key, 64, info=_KDF_INFO)
    return okm[:32], okm[32:]


# ======================================================================
# AES-128 (FIPS-197), vectorised over blocks
# ======================================================================
def _xtime(a: int) -> int:
    return ((a << 1) ^ (0x1B if a & 0x80 else 0)) & 0xFF


def _make_sbox() -> np.ndarray:
    """S-box = affine map of the GF(2^8) inverse (FIPS-197 sec 5.1.1)."""
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):               # 3 generates GF(2^8)*
        exp[i], log[x] = x, i
        x ^= _xtime(x)
    sbox = []
    for a in range(256):
        s = r = 0 if a == 0 else exp[(255 - log[a]) % 255]
        for _ in range(4):
            r = ((r << 1) | (r >> 7)) & 0xFF
            s ^= r
        sbox.append(s ^ 0x63)
    return np.array(sbox, dtype=np.uint8)


_SBOX = _make_sbox()
_XTIME = np.array([_xtime(a) for a in range(256)], dtype=np.uint8)
# ShiftRows on the column-major state (byte r + 4c = row r, column c):
# row r rotates left by r columns
_SHIFT_ROWS = np.array([r + 4 * ((c + r) % 4)
                        for c in range(4) for r in range(4)])


def aes128_round_keys(key: bytes) -> np.ndarray:
    """(11, 16) uint8 expanded key schedule (FIPS-197 sec 5.2)."""
    if len(key) != 16:
        raise ValueError("AES-128 key must be 16 bytes")
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(_SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, dtype=np.uint8).reshape(11, 16)


def aes128_encrypt_blocks(round_keys: np.ndarray,
                          blocks: np.ndarray) -> np.ndarray:
    """Encrypt (N, 16) uint8 blocks (ECB) in one pass over the batch."""
    s = np.ascontiguousarray(blocks, dtype=np.uint8) ^ round_keys[0]
    for rnd in range(1, 11):
        s = _SBOX[s[:, _SHIFT_ROWS]]           # SubBytes o ShiftRows
        if rnd < 10:                           # MixColumns, per column:
            a = s.reshape(-1, 4, 4)            # b_i = a_i ^ t ^ 2(a_i ^ a_i+1)
            t = a[..., 0] ^ a[..., 1] ^ a[..., 2] ^ a[..., 3]
            a ^= t[..., None] ^ _XTIME[a ^ np.roll(a, -1, axis=-1)]
        s ^= round_keys[rnd]
    return s


# ======================================================================
# ChaCha20-Poly1305 (RFC 8439)
# ======================================================================
_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4")


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    return (v << np.uint32(n)) | (v >> np.uint32(32 - n))


def _quarter_rounds(a, b, c, d) -> None:
    """Four quarter rounds at once: rows of (4, M) arrays, in place."""
    a += b
    d ^= a
    d[:] = _rotl(d, 16)
    c += d
    b ^= c
    b[:] = _rotl(b, 12)
    a += b
    d ^= a
    d[:] = _rotl(d, 8)
    c += d
    b ^= c
    b[:] = _rotl(b, 7)


def chacha20_stream(key: bytes, nonces: np.ndarray, counter: int,
                    n_blocks: int) -> np.ndarray:
    """Keystream for M nonces at once (RFC 8439 sec 2.3).

    ``nonces``: (M, 12) uint8.  Returns (M, 64 * n_blocks) uint8: blocks
    ``counter .. counter + n_blocks - 1`` of each nonce's stream, all
    M * n_blocks block functions evaluated in one vectorised pass.
    """
    nonces = np.ascontiguousarray(nonces, dtype=np.uint8).reshape(-1, 12)
    if len(key) != 32:
        raise ValueError("ChaCha20 needs a 32-byte key")
    m = nonces.shape[0]
    init = np.empty((16, m, n_blocks), dtype=np.uint32)
    init[0:4] = _SIGMA[:, None, None]
    init[4:12] = np.frombuffer(key, dtype="<u4")[:, None, None]
    init[12] = np.arange(counter, counter + n_blocks, dtype=np.uint32)
    init[13:16] = nonces.view("<u4").T[:, :, None]
    init = init.reshape(16, -1)
    x = init.copy()
    a, b, c, d = x[0:4], x[4:8], x[8:12], x[12:16]
    for _ in range(10):
        _quarter_rounds(a, b, c, d)                      # column round
        # diagonal round: rotate rows of b, c, d so diagonals line up
        b[:], c[:], d[:] = (np.roll(b, -1, 0), np.roll(c, -2, 0),
                            np.roll(d, -3, 0))
        _quarter_rounds(a, b, c, d)
        b[:], c[:], d[:] = (np.roll(b, 1, 0), np.roll(c, 2, 0),
                            np.roll(d, 3, 0))
    x += init
    return np.ascontiguousarray(x.T.astype("<u4")).view(np.uint8).reshape(
        m, 64 * n_blocks)


_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305_mac(key: bytes, msg: bytes) -> bytes:
    """One-time authenticator over ``msg`` (RFC 8439 sec 2.5)."""
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        n = int.from_bytes(msg[i:i + 16] + b"\x01", "little")
        acc = (acc + n) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _aead_tag(otk: bytes, aad: bytes, ct: bytes) -> bytes:
    def pad16(b: bytes) -> bytes:
        return bytes(-len(b) % 16)

    mac_data = (aad + pad16(aad) + ct + pad16(ct)
                + len(aad).to_bytes(8, "little")
                + len(ct).to_bytes(8, "little"))
    return poly1305_mac(otk, mac_data)


class ChaCha20Poly1305:
    """IETF AEAD construction (RFC 8439 sec 2.8): ct || 16-byte tag."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("ChaCha20-Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _otk_and_stream(self, nonces: np.ndarray, n: int) -> np.ndarray:
        """(M, 64 + n) uint8: Poly1305 one-time key block, then n bytes."""
        return chacha20_stream(self._key, nonces, 0, 1 + -(-n // 64))

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        ks = self._otk_and_stream(np.frombuffer(nonce, np.uint8), len(data))[0]
        ct = (np.frombuffer(data, np.uint8) ^ ks[64:64 + len(data)]).tobytes()
        return ct + _aead_tag(ks[:32].tobytes(), aad, ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        plain = self.decrypt_many(np.frombuffer(nonce, np.uint8)[None],
                                  np.frombuffer(data, np.uint8)[None], aad)[0]
        if plain is None:
            raise InvalidTag("authentication tag mismatch")
        return plain

    def decrypt_many(self, nonces: np.ndarray, data: np.ndarray,
                     aad: bytes = b"") -> list[bytes | None]:
        """Open M equal-length ``ct || tag`` rows; None where the tag fails.

        ``nonces`` (M, 12) and ``data`` (M, L) uint8.  One keystream pass
        serves every row; only the Poly1305 check runs per row.
        """
        data = np.asarray(data, dtype=np.uint8)
        m, n = data.shape[0], data.shape[1] - 16
        if n < 0:
            return [None] * m
        ks = self._otk_and_stream(nonces, n)
        plain = data[:, :n] ^ ks[:, 64:64 + n]
        out: list[bytes | None] = []
        for i in range(m):
            ct = data[i, :n].tobytes()
            tag = _aead_tag(ks[i, :32].tobytes(), aad, ct)
            ok = hmac.compare_digest(tag, data[i, n:].tobytes())
            out.append(plain[i].tobytes() if ok else None)
        return out


# ======================================================================
# PN keystream + channel facade
# ======================================================================
class PnStream:
    """Deterministic AES-128-ECB-in-CTR-layout pseudo-random bit stream.

    The per-frame counter space reserves 2**64 blocks per frame counter, so
    streams for different frames never collide.  Unlike the reference's
    one-block-at-a-time Python loop, this implementation assembles the whole
    counter-block buffer for a batch of frames and encrypts it in one
    vectorised AES pass.
    """

    def __init__(self, prng_key: bytes) -> None:
        sub_key = hashlib.blake2s(
            prng_key, digest_size=16, person=_PN_PERSON
        ).digest()
        self._round_keys = aes128_round_keys(sub_key)

    # -------------------------------------------------------------- raw bytes
    def block_bytes(self, frame_ctrs: np.ndarray, n_bytes: int) -> np.ndarray:
        """Return a (len(frame_ctrs), n_bytes) uint8 array of keystream."""
        ctrs = np.asarray(frame_ctrs, dtype=np.uint64).ravel()
        n_blocks = (n_bytes + 15) // 16
        # counter block = 16-byte big-endian of (ctr << 64) | blk
        # => bytes [0:8] = ctr big-endian, bytes [8:16] = blk big-endian.
        buf = np.zeros((ctrs.size, n_blocks, 16), dtype=np.uint8)
        hi = ctrs[:, None].byteswap().view(np.uint8).reshape(ctrs.size, 8)
        buf[:, :, :8] = hi[:, None, :]
        blks = np.arange(n_blocks, dtype=np.uint64).byteswap()
        buf[:, :, 8:] = blks.view(np.uint8).reshape(n_blocks, 8)[None, :, :]
        ks = aes128_encrypt_blocks(self._round_keys, buf.reshape(-1, 16))
        return ks.reshape(ctrs.size, n_blocks * 16)[:, :n_bytes]

    def bits(self, frame_ctr: int, n_bits: int) -> np.ndarray:
        """PN bits {0,1} uint8 for one frame (MSB-first per byte)."""
        return self.bits_batch(np.array([frame_ctr]), n_bits)[0]

    def bits_batch(self, frame_ctrs: np.ndarray, n_bits: int) -> np.ndarray:
        """PN bits for many frames at once: (len(frame_ctrs), n_bits) uint8."""
        raw = self.block_bytes(frame_ctrs, (n_bits + 7) // 8)
        return np.unpackbits(raw, axis=1)[:, :n_bits]


class SecureChannel:
    """AEAD seal/open plus the PN-bit facade (reference crypto.py:12-48)."""

    def __init__(self, master_key: bytes) -> None:
        aead_key, prng_key = derive_subkeys(master_key)
        self._aead = ChaCha20Poly1305(aead_key)
        self._pn = PnStream(prng_key)

    # ---------------------------------------------------------------- AEAD
    def seal(self, plaintext: bytes) -> bytes:
        """nonce(12) || ciphertext || tag(16)."""
        nonce = secrets.token_bytes(12)
        return nonce + self._aead.encrypt(nonce, plaintext, b"")

    def open(self, blob: bytes) -> bytes:
        """Inverse of :meth:`seal`; raises ``InvalidTag`` on failure."""
        if len(blob) < 12 + 16:
            raise ValueError("ciphertext too short")
        return self._aead.decrypt(blob[:12], blob[12:], b"")

    def open_any_layout(self, blob: bytes) -> tuple[bytes | None, str | None]:
        """Try nonce-front then nonce-tail layouts (detector.py:418-448)."""
        return self.open_any_layout_many(
            np.frombuffer(blob, dtype=np.uint8)[None])[0]

    def open_any_layout_many(self, blobs: np.ndarray
                             ) -> list[tuple[bytes | None, str | None]]:
        """``open_any_layout`` for (M, L) uint8 equal-length blobs at once."""
        blobs = np.asarray(blobs, dtype=np.uint8)
        m = blobs.shape[0]
        res: list[tuple[bytes | None, str | None]] = [(None, None)] * m
        if blobs.shape[1] < 12 or m == 0:
            return res
        front = self._aead.decrypt_many(blobs[:, :12], blobs[:, 12:])
        for i, p in enumerate(front):
            if p is not None:
                res[i] = (p, "nonce-front")
        retry = [i for i, p in enumerate(front) if p is None]
        if retry:
            tail = self._aead.decrypt_many(blobs[retry, -12:],
                                           blobs[retry, :-12])
            for i, p in zip(retry, tail):
                if p is not None:
                    res[i] = (p, "nonce-tail")
        return res

    # ------------------------------------------------------------------ PN
    def pn_bits(self, frame_ctr: int, n_bits: int) -> np.ndarray:
        return self._pn.bits(frame_ctr, n_bits)

    def pn_bits_batch(self, frame_ctrs: np.ndarray, n_bits: int) -> np.ndarray:
        return self._pn.bits_batch(frame_ctrs, n_bits)
