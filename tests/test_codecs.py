"""REAL codec round-trips (stdlib audioop): the measured envelope pins.

The reference claims codec survival with no test (reference
README.md:163; SURVEY.md §6).  This image has no ffmpeg/lame/sox, but
stdlib ``audioop`` ships actual encoder/decoder pairs for G.711
mu-law / A-law (8-bit companding) and IMA ADPCM (4-bit differential),
plus a real linear-interpolation rate converter -- so these rows are
genuine encode->decode round-trips, not simulations.  Verdicts are
pinned to the measured envelope (benchmarks/codec_envelope.py); if a
demod improvement flips a rejected row to True, update the pin -- the
wrong-key rows must NEVER flip.
"""
import numpy as np
import pytest

from echoseal_tpu.models.robust import RobustEmbedder, RobustVerifier
from echoseal_tpu.utils import channels

pytest.importorskip("audioop")

FS = 48_000


@pytest.fixture(scope="module")
def v2_clip(key32):
    tx = RobustEmbedder(key32)
    tx._session_nonce = b"codecpin"
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(6 * FS) / FS)
            ).astype(np.float32)
    wm = tx.process(host)
    return np.ascontiguousarray(wm[FS : FS + 4 * FS])


def test_ulaw_roundtrip_bitwidth():
    """mu-law is a real 8-bit codec: output is quantised, non-identical."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(4096)).astype(np.float32)
    y = channels.codec_ulaw(x)
    err = x - y
    assert 1e-4 < float(np.sqrt(np.mean(err * err))) < 0.05
    # companding: small samples get FINER steps than large ones
    assert np.unique(np.round(y * 32767)).size < 256 + 1


def test_v2_survives_ulaw(key32, v2_clip):
    y = channels.codec_ulaw(v2_clip)
    assert RobustVerifier(key32).verify(y, FS) is True
    assert RobustVerifier(bytes.fromhex("44" * 32)).verify(y, FS) is False


def test_v2_survives_alaw(key32, v2_clip):
    assert RobustVerifier(key32).verify(
        channels.codec_alaw(v2_clip), FS) is True


def test_v2_adpcm_envelope(key32, v2_clip):
    """IMA ADPCM (4-bit differential) survives: the measured pin.

    Measured accept 1.0 over independent (nonce, excerpt) draws
    (benchmarks/codec_envelope.py) -- the 8x-oversampled v2 chips keep
    enough per-chip energy below ADPCM's slope-noise knee.  Wrong key
    must reject regardless.
    """
    y = channels.codec_adpcm(v2_clip)
    assert RobustVerifier(key32).verify(y, FS) is True
    assert RobustVerifier(bytes.fromhex("44" * 32)).verify(y, FS) is False


def test_v2_ratecv_capture(key32, v2_clip):
    """48 kHz playback captured by a 44.1 kHz clock via audioop.ratecv."""
    y = channels.codec_ratecv(v2_clip, FS, 44_100)
    assert RobustVerifier(key32).verify(y, 44_100) is True


def test_mpeg1_filterbank_near_pr():
    """The designed 512-tap window pair reconstructs at >=60 dB SNR.

    Pins the data/pqmf512.py payload against the ISO filterbank
    equations (utils/mpeg1.py analyze/synthesize) at the documented
    integer delay of 481 samples and unit gain.
    """
    from echoseal_tpu.data.pqmf512 import DELAY
    from echoseal_tpu.utils.mpeg1 import analyze, synthesize

    rng = np.random.default_rng(0)
    x = rng.standard_normal(32 * 300)
    y = synthesize(analyze(x))
    err = y[DELAY: DELAY + 6000] - x[:6000]
    snr = 10 * np.log10(np.mean(x[:6000] ** 2) / np.mean(err ** 2))
    assert snr >= 60.0 and DELAY == 481


def test_mpeg1_bitstream_rate_and_loss():
    """The Layer II stream is a REAL bitstream at the stated bitrate.

    Byte count must equal the ISO frame budget exactly (1152 samples *
    bitrate / fs bits per frame + the 60-bit stream header) -- nothing
    can leak around the budget -- and the round-trip must be lossy but
    close (a perceptual codec, not a passthrough).
    """
    from echoseal_tpu.utils.mpeg1 import DELAY, FRAME_SAMPLES, encode, \
        roundtrip

    rng = np.random.default_rng(1)
    t = np.arange(int(1.5 * FS))
    x = (0.3 * np.sin(2 * np.pi * 440 * t / FS)
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    for br in (128, 192):
        blob = encode(x, FS, br)
        n_frames = -(-(x.size + DELAY) // FRAME_SAMPLES)
        want_bits = 60 + n_frames * (FRAME_SAMPLES * br * 1000 // FS)
        assert len(blob) == -(-want_bits // 8)
        y = roundtrip(x, FS, br)
        err = y - x
        snr = 10 * np.log10(np.mean(x**2) / np.mean(err**2))
        assert 10.0 < snr < 80.0 and not np.array_equal(y, x)
    # decoder rejects a stream with a corrupted magic
    bad = bytearray(encode(x[:FS], FS, 128))
    bad[0] ^= 0xFF
    from echoseal_tpu.utils.mpeg1 import decode

    with pytest.raises(ValueError):
        decode(bytes(bad))


def test_v2_survives_mpeg1_l2_128k(key32, v2_clip):
    """REAL MPEG-1 Layer II at 128 kbps: the reference's headline codec
    claim (reference README.md:163), now an actual encode->decode
    round-trip instead of the windowed-DFT simulation."""
    y = channels.codec_mpeg1_l2(v2_clip, 128)
    assert RobustVerifier(key32).verify(y, FS) is True
    assert RobustVerifier(bytes.fromhex("44" * 32)).verify(y, FS) is False


def test_v2_survives_mpeg1_l2_64k(key32, v2_clip):
    """Measured envelope extends to 64 kbps mono Layer II."""
    y = channels.codec_mpeg1_l2(v2_clip, 64)
    assert RobustVerifier(key32).verify(y, FS) is True


def test_compat_rejects_real_codec_gracefully(key32):
    """Compat (digitally-clean carrier) rejects an 8-bit trunk capture.

    Measured envelope (benchmarks/codec_envelope.py): compat accept 0.0
    through every real codec, wrong-key accept 0.0 -- graceful rejection,
    no false positives.  If a demod improvement flips the right-key row
    to True, update the pin; the wrong-key row must NEVER flip.
    """
    from echoseal_tpu.models.detector import WatermarkDetector
    from echoseal_tpu.models.embedder import BatchEmbedder

    be = BatchEmbedder(key32)
    wm = be.embed(np.zeros(5 * FS, dtype=np.float32),
                  session_nonce=b"codecrej")
    y = channels.codec_ulaw(wm[: 4 * FS])
    assert WatermarkDetector(key32, list_size=16).verify(y, FS) is False
    assert WatermarkDetector(bytes.fromhex("44" * 32),
                             list_size=8).verify(y, FS) is False


def test_mpeg1_l3_bitstream_rate_and_loss():
    """The Layer III stream is a REAL bitstream at the stated bitrate.

    Byte count equals the CBR budget exactly (the bit reservoir shifts
    bits BETWEEN granules, never past the constant rate), and the
    round-trip is lossy-but-close at 128 kbps.
    """
    from echoseal_tpu.utils.mpeg1_l3 import (DELAY, FRAME_SAMPLES, GRANULE,
                                             decode, encode, roundtrip)

    rng = np.random.default_rng(2)
    t = np.arange(int(1.5 * FS))
    x = (0.3 * np.sin(2 * np.pi * 440 * t / FS)
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    for br in (128, 192):
        blob = encode(x, FS, br)
        n_frames = -(-(x.size + DELAY + GRANULE) // FRAME_SAMPLES)
        want_bits = 60 + n_frames * (FRAME_SAMPLES * br * 1000 // FS)
        assert len(blob) == -(-want_bits // 8)
        y = roundtrip(x, FS, br)
        err = y - x
        snr = 10 * np.log10(np.mean(x**2) / np.mean(err**2))
        assert 8.0 < snr < 80.0 and not np.array_equal(y, x)
    with pytest.raises(ValueError):
        bad = bytearray(encode(x[:FS], FS, 128))
        bad[0] ^= 0xFF
        decode(bytes(bad))


def test_mpeg1_l3_rate_distortion_monotone():
    """More bits -> less distortion: the rate loop is load-bearing."""
    from echoseal_tpu.utils.mpeg1_l3 import roundtrip

    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal(FS)).astype(np.float32)
    snrs = []
    for br in (64, 128, 192):
        y = roundtrip(x, FS, br)
        err = y - x
        snrs.append(10 * np.log10(np.mean(x**2) / np.mean(err**2)))
    assert snrs[0] < snrs[1] < snrs[2]


def test_mpeg1_l3_mdct_alias_inverse():
    """Encoder/decoder alias rotations are exact inverses, and the
    MDCT/IMDCT pair reconstructs (TDAC) through the granule path."""
    from echoseal_tpu.utils.mpeg1_l3 import (_alias_reduce, _imdct_granules,
                                             _mdct_granules)

    rng = np.random.default_rng(4)
    X = rng.standard_normal((3, 576))
    np.testing.assert_allclose(
        _alias_reduce(_alias_reduce(X, inverse=True), inverse=False), X,
        atol=1e-12)
    s = rng.standard_normal((18 * 6, 32))
    back = _imdct_granules(_mdct_granules(s))
    # 18-row MDCT latency; interior rows reconstruct exactly
    np.testing.assert_allclose(back[18:-18], s[:-36], atol=1e-10)


def test_v2_survives_mpeg1_l3_128k(key32, v2_clip):
    """REAL MPEG-1 Layer III at 128 kbps: the reference's LITERAL claim
    ("MP3 128 kbps", reference README.md:47,163), now an actual
    MDCT/Huffman/bit-reservoir encode->decode round-trip."""
    y = channels.codec_mpeg1_l3(v2_clip, 128)
    assert RobustVerifier(key32).verify(y, FS) is True
    assert RobustVerifier(bytes.fromhex("44" * 32)).verify(y, FS) is False


def test_v2_survives_mpeg1_l3_64k(key32, v2_clip):
    """Measured envelope extends to 64 kbps mono Layer III."""
    y = channels.codec_mpeg1_l3(v2_clip, 64)
    assert RobustVerifier(key32).verify(y, FS) is True
