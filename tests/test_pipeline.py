"""Batched verify pipeline + shard_map scale-out."""
import numpy as np
import pytest

from echoseal_tpu.core.params import FRAME_LEN
from echoseal_tpu.models.embedder import BatchEmbedder
from echoseal_tpu.models.pipeline import BatchVerifier

FS = 48_000


@pytest.fixture(scope="module")
def batch(key32):
    """8 watermarked 3 s clips cut from mid-stream counters + verifier."""
    be = BatchEmbedder(key32)
    T = 3 * FS
    Tpad = 1 << 18
    n_frames = -(-T // FRAME_LEN)
    rng = np.random.default_rng(1)
    clips = np.zeros((8, Tpad), dtype=np.float32)
    scale = 10.0 ** (be.p.floor_rel_dbfs / 20.0)
    for i in range(8):
        sc = int(rng.integers(0, 2000))
        fr = be.frames(np.arange(sc, sc + n_frames), session_nonce=bytes(8))
        clips[i, :T] = fr.reshape(-1)[:T] * scale
    nv = np.full(8, T, dtype=np.int32)
    return clips, nv, BatchVerifier(key32, max_ctr=4096)


def test_batch_verify_true_positives(batch):
    clips, nv, bv = batch
    assert bool(np.all(bv.verify_batch(clips, nv)))


def test_batch_verify_rejects_noise(batch, rng):
    clips, nv, bv = batch
    noise = (0.05 * rng.standard_normal(clips.shape)).astype(np.float32)
    assert not bool(np.any(bv.verify_batch(noise, nv)))


def test_batch_verify_wrong_key(batch, key32):
    clips, nv, _ = batch
    bv_bad = BatchVerifier(bytes.fromhex("99" * 32), max_ctr=4096)
    assert not bool(np.any(bv_bad.verify_batch(clips, nv)))


def test_shard_map_verify_multidevice(batch):
    import jax

    from echoseal_tpu.parallel.mesh import shard_verify, streams_mesh

    clips, nv, bv = batch
    n_dev = len(jax.devices())
    assert n_dev >= 2, "conftest should provide 8 virtual CPU devices"
    mesh = streams_mesh()
    run = shard_verify(bv, mesh)
    out = run(clips, nv)
    jax.block_until_ready(out)
    assert int(out["n_crc_ok"]) >= 8        # every clip has a decode
    verdicts = bv.finish_host(out)
    assert bool(np.all(verdicts))


# ---------------------------------------------------------------- v2 batch
@pytest.fixture(scope="module")
def v2_batch(key32):
    """4 v2 clips: clean loud-host, MP3-sim, silence+AWGN(+4dB), no wm."""
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    T = int(3.5 * FS)
    Tpad = 1 << 18
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    tx_loud = RobustEmbedder(key32)
    tx_loud._session_nonce = b"sessionA"   # pinned: nonce tests read these
    wm_loud = tx_loud.process(host)
    tx_sil = RobustEmbedder(key32)
    tx_sil._session_nonce = b"sessionB"
    wm_sil = tx_sil.process(np.zeros(T, np.float32))
    rms = float(np.sqrt(np.mean(wm_sil**2)))
    rng = np.random.default_rng(3)
    clips = np.zeros((4, Tpad), np.float32)
    clips[0, :T] = wm_loud
    clips[1, :T] = channels.codec_sim(wm_loud, 128.0)[:T]
    clips[2, :T] = wm_sil + rms * 10 ** (-4 / 20) * rng.standard_normal(
        T).astype(np.float32)
    clips[3, :T] = 0.05 * rng.standard_normal(T).astype(np.float32)
    return clips, np.full(4, T, dtype=np.int32)


def test_robust_batch_verifier(key32, v2_batch):
    """One-dispatch v2 batch: hard pass + SCL fallback (BASELINE config 5).

    The MP3-sim and AWGN rows are only decodable through the list decoder
    (their hard pass fails -- asserted below), so this pins the SCL
    fallback stage as load-bearing in the serving tier, not dead config.
    """
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    hard = bv.verify_batch(clips, nv, use_scl=False)
    # rows 0 (clean loud host) and 1 (MP3-sim of it) have rounding-
    # adjacent hard-pass margins (platform AOT rounding has flipped each
    # direction once -- VERDICT r2 weak #2 / round-3 rerun), so their
    # binding assertions are the full-ladder verdicts below; the hard/scl
    # split stays pinned on the wide-margin silence-host AWGN row (+4 dB
    # sits ~6 dB below the measured hard envelope) and the no-watermark
    # row, which no rounding can rescue.
    assert not bool(hard[3])
    assert not bool(hard[2])                         # needs the list decoder
    full = bv.verify_batch(clips, nv)
    assert full.tolist() == [True, True, True, False]


def test_bf16_table_storage_verdict_parity(key32, v2_batch):
    """bf16-stored demod tables give identical verdicts to f32.

    ``table_dtype="bf16"`` halves the ~378 MB verifier tables; the demod einsum promotes the table back to f32
    on device, so the only numerical effect is the one-time table
    quantisation.  This pins the knob as load-bearing AND verdict-safe:
    the full 4-row corpus (clean loud host / MP3-sim / AWGN / no-wm)
    must agree row for row with the f32 verifier, including the
    no-watermark rejection.
    """
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    v16 = RobustBatchVerifier(key32, max_ctr=4096,
                              table_dtype="bf16").verify_batch(clips, nv)
    assert v16.tolist() == [True, True, True, False]


def test_sync_dtype_knob_verdict_parity(key32, v2_batch):
    """``sync_dtype`` (bf16 tensor-core sync conv vs f32) is verdict-safe.

    The v2 sync conv runs bf16 by default (the 504-tap conv over the
    padded batch is the stage's largest contraction); ``sync_dtype="f32"``
    exists for precision-sensitivity attribution (the timescale-recovery
    residual, benchmarks/timescale_attrib.py) and for the small retry
    batches where exact peak placement matters more than conv
    throughput.  Both settings must agree on the 4-row corpus, and the
    per-call ``run_device(..., sync_dtype=...)`` override must not
    disturb the constructed default.
    """
    import jax.numpy as jnp

    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    bv = RobustBatchVerifier(key32, max_ctr=4096, sync_dtype="bf16")
    v16 = bv.verify_batch(clips, nv)
    assert v16.tolist() == [True, True, True, False]
    out = bv.run_device(clips, nv, sync_dtype=jnp.float32)
    v32 = bv._finish_ladder(out, None, True, 1 << 20)
    assert v32.tolist() == [True, True, True, False]
    assert bv._sync_dtype == jnp.bfloat16     # override was per-call only


def test_v2_batch_ingest_44k1(key32, v2_batch):
    """``verify_batch(..., fs_in=44100)``: device ingest rate conversion.

    A 44.1 kHz capture of the v2 corpus must (a) verdict-match the
    host-resample reference path row for row, and (b) keep the clean
    accept and the no-watermark rejection absolutely.  T_in is chosen so
    the device-resampled width lands exactly on the corpus' 1<<18 pad
    (ceil(240844 * 160/147) = 262144), sharing the stage compile.
    """
    from scipy.signal import resample_poly

    from echoseal_tpu.models.detector import resample_to
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    T_in = 240_844
    cap = resample_poly(clips.astype(np.float64), 147, 160,
                        axis=-1)[:, :T_in].astype(np.float32)
    nv44 = (nv.astype(np.int64) * 147 // 160).astype(np.int32)

    bv = RobustBatchVerifier(key32, max_ctr=4096)
    dev = bv.verify_batch(cap, nv44, fs_in=44_100)

    back = np.stack([resample_to(FS, row, 44_100) for row in cap])
    ref_clips = np.zeros((cap.shape[0], 1 << 18), np.float32)
    ref_clips[:, : back.shape[1]] = back[:, : 1 << 18]
    ref = bv.verify_batch(
        ref_clips, np.minimum(nv44.astype(np.int64) * 160 // 147,
                              back.shape[1]).astype(np.int32))
    assert dev.tolist() == ref.tolist()
    assert bool(dev[0]) and not bool(dev[3])


def test_v2_batch_ingest_96k_decimation(key32, v2_batch):
    """Decimating ingest (96 kHz capture) through the scaled lattice.

    96 kHz reduces to up=1/down=2, which _ingest rescales to a >=128
    lattice so the window tensor stays ~1.4x the input batch instead of
    ~55x.  T_in = 2*(1<<18) lands the output exactly on the corpus'
    1<<18 width (shared stage compile).  Only rows with wide margins are
    pinned absolutely (clean accept / no-wm reject).
    """
    from scipy.signal import resample_poly

    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    cap = resample_poly(clips.astype(np.float64), 2, 1,
                        axis=-1).astype(np.float32)       # (4, 2*(1<<18))
    assert cap.shape[-1] == 2 * (1 << 18)
    dev = RobustBatchVerifier(key32, max_ctr=4096).verify_batch(
        cap, nv.astype(np.int64) * 2, fs_in=96_000)
    assert bool(dev[0]) and not bool(dev[3])


def test_robust_batch_timescale_recovery(key32, v2_batch, monkeypatch):
    """Batched +-5% playback-speed recovery with no caller hint.

    Scan (device) -> grouped host resample -> one re-verify dispatch ->
    peak-spacing refinement round, mirroring the single-clip ladder.

    The TX payload padding and session nonce are pinned: the recovery
    margin of an off-grid factor is payload-dependent, and a freshly
    randomized waveform per run made the 2/2 requirement a coin with a
    rare bad side (observed one miss in an otherwise green run).
    """
    import echoseal_tpu.models.robust as robust_mod
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    class _FixedSecrets:
        @staticmethod
        def token_bytes(n: int) -> bytes:
            return bytes(range(1, n + 1))

    monkeypatch.setattr(robust_mod, "secrets", _FixedSecrets)

    T = int(3.5 * FS)
    Tpad = 1 << 18
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    wm = RobustEmbedder(key32).process(host)
    clips = np.zeros((2, Tpad), np.float32)
    nv = np.zeros(2, np.int32)
    for i, f in enumerate((1.031, 0.978)):      # off the scan grid
        y = channels.time_scale(wm, f)
        L = min(y.size, Tpad)
        clips[i, :L] = y[:L]
        nv[i] = L
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    assert not bv.verify_batch(clips, nv).any()         # hidden without it
    assert bv.verify_batch_recover(clips, nv).all()


def test_recover_reciprocal_fallback_rescues_wrong_basin(key32, monkeypatch):
    """A scan that argmaxes the RECIPROCAL basin must still recover.

    benchmarks/timescale_attrib.py (1024 scaled clips): every
    residual recovery failure tried exactly one factor ~1/true -- the
    scaled-template scan aliases into the reciprocal basin for a few
    percent of clips, the retry there shows no peaks, and the refiner
    abstains.  The fallback queue (reciprocal first) must turn those
    into accepts.  The scan is monkeypatched to the wrong basin so the
    mechanism is pinned deterministically, not on a lucky clip.
    """
    import echoseal_tpu.models.robust as robust_mod
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import SCALE_SCAN_GRID, RobustEmbedder
    from echoseal_tpu.utils import channels

    class _FixedSecrets:
        @staticmethod
        def token_bytes(n: int) -> bytes:
            return bytes(range(1, n + 1))

    monkeypatch.setattr(robust_mod, "secrets", _FixedSecrets)

    wrong_i = SCALE_SCAN_GRID.index(0.97)   # reciprocal of true 1.031

    def wrong_basin_scan(x, nv, bank):
        s = np.zeros((x.shape[0], bank.shape[0]), np.float32)
        s[:, 4 * wrong_i : 4 * wrong_i + 4] = 1.0
        return s

    monkeypatch.setattr(robust_mod, "_scale_scan_batch", wrong_basin_scan)

    T = int(3.5 * FS)
    Tpad = 1 << 18
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    wm = RobustEmbedder(key32).process(host)
    y = channels.time_scale(wm, 1.031)
    clips = np.zeros((2, Tpad), np.float32)
    nv = np.zeros(2, np.int32)
    for i in range(2):
        L = min(y.size, Tpad)
        clips[i, :L] = y[:L]
        nv[i] = L
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    assert bv.verify_batch_recover(clips, nv).all()


def test_refine_chains_sub_1e4_lattice_residual(key32, monkeypatch):
    """A spacing estimate INSIDE the old 1e-4 abstain window must chain.

    For true playback 1.031 the scan picks grid 0.97 (den 11640 on the
    RETRY_UP=12000 lattice, residual +7.0e-5); the correct next
    candidate is the ADJACENT lattice point 11639/12000 (residual
    -1.6e-5).  The old 1e-4 refinement threshold abstained on every
    such estimate -- masking the lattice's own quantization -- and the
    ~5% of clips that cannot tolerate the residual were lost
    (benchmarks/timescale_attrib.py `correct_factor` class, 50/51 of
    residual failures on chip).  run_device/_finish_ladder are stubbed
    to always-fail so the lattice walk is pinned deterministically,
    not on decode luck.
    """
    import jax.numpy as jnp

    import echoseal_tpu.models.robust as robust_mod
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    bv = RobustBatchVerifier(key32, max_ctr=256)
    Tpad = 1 << 17
    clips = np.zeros((1, Tpad), np.float32)
    nv = np.full(1, Tpad, np.int32)
    dev = jnp.asarray(clips)

    monkeypatch.setattr(robust_mod, "estimate_timescale_from_peaks",
                        lambda peaks, span: 1.0 - 7.0e-5)

    def fake_run_device(batch, nv2):
        B = int(np.shape(batch)[0])
        return {"peak_val": jnp.ones((B, 4, bv.peaks)),
                "peak_idx": jnp.zeros((B, 4, bv.peaks), jnp.int32)}

    monkeypatch.setattr(bv, "run_device", fake_run_device)
    monkeypatch.setattr(bv, "_finish_ladder",
                        lambda *a, **k: np.zeros(1, bool))

    calls: list[list[int]] = []
    orig = RobustBatchVerifier._retry_scaled

    def spy(self, c, n, factors, *a, **k):
        calls.append(sorted(int(round(self.RETRY_UP * f))
                            for f in factors.values()))
        return orig(self, c, n, factors, *a, **k)

    monkeypatch.setattr(RobustBatchVerifier, "_retry_scaled", spy)
    bv._retry_scaled(clips, nv, {0: 0.97}, np.zeros(1, bool), None,
                     refine=2, clips_dev=dev, nv_dev=nv)
    assert calls[0] == [11640]
    # the refinement round must walk to the adjacent lattice point
    # instead of abstaining (old behavior: calls == [[11640]])
    assert 11639 in [k for ks in calls[1:] for k in ks]


def test_recover_accepts_device_resident_clips(key32, v2_batch, monkeypatch):
    """``verify_batch_recover`` on a ``jax.Array`` batch: no host upload.

    A serving loop that stages batches on device ahead of time must get
    identical verdicts without the ~740 MB/1k-batch host->device
    transfer the np.ndarray path pays.  Host bytes may
    only be materialized inside the out-of-family resample fallback --
    exercised directly with a factor past the compiled +-5% family.
    """
    import jax
    import jax.numpy as jnp

    import echoseal_tpu.models.robust as robust_mod
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    class _FixedSecrets:
        @staticmethod
        def token_bytes(n: int) -> bytes:
            return bytes(range(1, n + 1))

    monkeypatch.setattr(robust_mod, "secrets", _FixedSecrets)

    T = int(3.5 * FS)
    Tpad = 1 << 18
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    wm = RobustEmbedder(key32).process(host)
    clips = np.zeros((2, Tpad), np.float32)
    nv = np.zeros(2, np.int32)
    for i, f in enumerate((1.031, 1.0)):
        y = channels.time_scale(wm, f)
        L = min(y.size, Tpad)
        clips[i, :L] = y[:L]
        nv[i] = L
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    dev = jax.device_put(jnp.asarray(clips))
    v_dev = bv.verify_batch_recover(dev, nv)
    assert v_dev.tolist() == bv.verify_batch_recover(clips, nv).tolist()
    assert v_dev.all()

    # lazy host materialization: out-of-family factor, clips passed None
    v0 = np.zeros(2, bool)
    out = bv._retry_scaled(None, nv, {0: 1.2}, v0, None, refine=0,
                           clips_dev=dev, nv_dev=nv, fs_host=FS)
    assert out.dtype == bool and not out[0]   # junk factor cannot accept


def test_recover_composes_with_fs_in_ingest(key32, monkeypatch):
    """``verify_batch_recover(fs_in=44100)``: ingest + speed recovery.

    A 44.1 kHz capture that was ALSO played ~3% fast previously needed a
    host resample before the recovery call (VERDICT r3 weak #6).  Now
    the device ingest converts the batch once, the scan/retry ladder
    runs on the 48 kHz device timeline, and the host-fallback resample
    (if a factor lands outside the compiled +-5% family) corrects
    straight from the 44.1 kHz clips in one composed polyphase pass.
    T_in = 240844 lands the ingest output exactly on the 1<<18 width the
    recovery fixtures compile.
    """
    from scipy.signal import resample_poly

    import echoseal_tpu.models.robust as robust_mod
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    class _FixedSecrets:
        @staticmethod
        def token_bytes(n: int) -> bytes:
            return bytes(range(1, n + 1))

    monkeypatch.setattr(robust_mod, "secrets", _FixedSecrets)

    T = int(3.5 * FS)
    T_in = 240_844
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    wm = RobustEmbedder(key32).process(host)
    clips = np.zeros((2, T_in), np.float32)
    nv = np.zeros(2, np.int32)
    for i, f in enumerate((1.031, 0.978)):      # off the scan grid
        y = channels.time_scale(wm, f)          # wrong playback speed...
        cap = resample_poly(y.astype(np.float64), 147, 160).astype(
            np.float32)                          # ...captured at 44.1 kHz
        L = min(cap.size, T_in)
        clips[i, :L] = cap[:L]
        nv[i] = L
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    assert not bv.verify_batch(clips, nv, fs_in=44_100).any()
    assert bv.verify_batch_recover(clips, nv, fs_in=44_100).all()


def test_device_resident_fs_in_host_fallback_rate(key32, monkeypatch):
    """Out-of-family host fallback on a device-resident ``fs_in`` batch.

    ``_retry_scaled``'s lazily-materialized rows live on the 48 kHz
    INGESTED device timeline, not the original capture rate: the host
    polyphase must correct with fs=48 kHz + the ingested lengths (review
    r4 finding: pairing the materialized 48 kHz rows with the 44.1 kHz
    ``fs_host`` lattice applied a spurious ~8.8% extra speed shift, so
    any device-resident 44.1 kHz clip whose recovered factor fell
    outside the compiled +-5% device family was silently rejected).
    Pinned by driving the host branch directly with a correction factor
    past the device family (1.06) on a 44.1 kHz-captured clip that was
    played 6% SLOW (time_scale 1/1.06: the spectrum shifts DOWN, so the
    hop bands stay under the capture Nyquist; correction factor f
    resamples by 1/f -- tests/test_pipeline.py factor-direction probe).
    """
    import jax
    import jax.numpy as jnp
    from scipy.signal import resample_poly

    import echoseal_tpu.models.robust as robust_mod
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder

    class _FixedSecrets:
        @staticmethod
        def token_bytes(n: int) -> bytes:
            return bytes(range(1, n + 1))

    monkeypatch.setattr(robust_mod, "secrets", _FixedSecrets)

    T = int(3.5 * FS)
    T_in = 240_844                 # ingest output lands exactly on 1<<18
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    wm = RobustEmbedder(key32).process(host)
    # played 6% slow as the EXACT rational 53/50 (channels.time_scale
    # would quantize 1/1.06 to 1000/943, a 4.2e-4 residual -- outside
    # the demod's ~2e-4 coherence budget, which would mask this test)
    y = resample_poly(wm.astype(np.float64), 53, 50).astype(np.float32)
    cap = resample_poly(y.astype(np.float64), 147, 160).astype(np.float32)
    clips = np.zeros((2, T_in), np.float32)
    nv = np.zeros(2, np.int32)
    L = min(cap.size, T_in)
    clips[:, :L] = cap[:L]
    nv[:] = L
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    dev = jax.device_put(jnp.asarray(clips))
    clips48, nv48 = bv._ingest(dev, nv, 44_100)
    v0 = np.zeros(2, bool)
    out = bv._retry_scaled(None, nv, {0: 1.06}, v0, None, refine=0,
                           clips_dev=clips48,
                           nv_dev=np.asarray(nv48, np.int32),
                           fs_host=44_100)
    assert out[0], "host fallback must correct on the ingested timeline"


def test_retry_identity_lattice_guard(key32, v2_batch):
    """Retry factors that quantize to the lattice identity are skipped.

    The round-4 chip attribution run crashed in DeviceResampler
    ("resample factor 1.0 is the identity") when a chained refinement
    candidate cancelled to ~1.0 (f1 * fine ~ 1) and the reciprocal
    fallback could re-quantize there too.  An identity retry would just
    re-verify the already-failed clip, so the candidate selection and
    the group dispatch both skip the ``den == up`` lattice point; an
    all-identity round returns without dispatching anything.
    """
    import jax
    import jax.numpy as jnp

    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    dev = jax.device_put(jnp.asarray(clips))
    v0 = np.zeros(4, bool)
    out = bv._retry_scaled(None, nv, {3: 1.0}, v0, None, refine=0,
                           clips_dev=dev, nv_dev=nv, fs_host=FS)
    assert not out.any()


def test_recover_defers_escalation_for_unscaled_clips(key32, v2_batch):
    """``verify_batch_recover`` verdict-matches ``verify_batch`` on a
    batch with NO time-scaled clips.

    The round-4 restructure moved SCL/extended-counter escalation BEHIND
    the scale scan (a scaled batch burned ~20 s of undecodable list
    decoding before the scan even ran); clips the scan cannot place must
    still be rescued by the deferred escalation against the same device
    outputs -- including SCL-only rows (mp3-sim / AWGN) -- and the
    headerless noise row must stay rejected and futility-gated.
    """
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    v = bv.verify_batch_recover(clips, nv)
    assert v.tolist() == [True, True, True, False]


def test_payload_rate_knob_roundtrip(key32):
    """payload_k=360 (the AEAD-envelope floor) round-trips end to end.

    The noise-capacity frontier's rate axis (benchmarks/awgn_envelope.py
    --rates, VERDICT r3 next #6): a lower-rate Polar(1024, 360) spec
    carries the same sealed blob with zero random padding.  Rate
    mismatch must reject: the K=448 verifier sees the K=360 waveform as
    noise (different codebook), and vice versa the knob is profile-
    scoped, so compat stays pinned at the wire format's K=448.
    """
    import pytest as _pytest

    from echoseal_tpu.core.profiles import WaveformProfile
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder

    lr = WaveformProfile("robust8lr", oversample=8,
                         standard_info_set=True, payload_k=360)
    T = int(3.5 * FS)
    Tpad = 1 << 18
    wm = RobustEmbedder(key32, profile=lr).process(np.zeros(T, np.float32))
    clips = np.zeros((1, Tpad), np.float32)
    clips[0, :T] = wm
    nv = np.full(1, T, np.int32)
    assert RobustBatchVerifier(key32, max_ctr=4096,
                               profile=lr).verify_batch(clips, nv).all()
    assert not RobustBatchVerifier(key32, max_ctr=4096).verify_batch(
        clips, nv).any()
    # the knob validates its own envelope floor and compat immutability
    with _pytest.raises(ValueError):
        WaveformProfile("bad", oversample=8, standard_info_set=True,
                        payload_k=232)
    with _pytest.raises(ValueError):
        WaveformProfile("bad", oversample=1, standard_info_set=False,
                        payload_k=360)


def test_batch_verify_past_pn_table_ceiling(key32):
    """A clip cut past the device PN table (ctr >= 2**16) still verifies.

    The round-1 pipeline silently failed here (table pass only); the
    extended-counter pass resolves lo16 + m*2**16 with host-generated PN.
    """
    from echoseal_tpu.models.pipeline import BatchVerifier

    be = BatchEmbedder(key32)
    T = 3 * FS
    Tpad = 1 << 18
    n_frames = -(-T // FRAME_LEN)
    scale = 10.0 ** (be.p.floor_rel_dbfs / 20.0)
    sc = 70_000                      # ~29.5 min into the stream, > 2**16
    fr = be.frames(np.arange(sc, sc + n_frames), session_nonce=bytes(8))
    clips = np.zeros((1, Tpad), dtype=np.float32)
    clips[0, :T] = fr.reshape(-1)[:T] * scale
    nv = np.full(1, T, dtype=np.int32)
    bv = BatchVerifier(key32, max_ctr=4096)
    out = bv.run_device(clips, nv)
    assert not bv.finish_host(out).any()          # table pass alone misses
    assert bv.verify_batch(clips, nv).all()       # escalation resolves it


def test_robust_batch_expected_nonce(key32, v2_batch):
    """The serving anti-replay hook rejects frames from another session."""
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    clips, nv = v2_batch
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    ok = bv.verify_batch(clips[:1], nv[:1])
    assert bool(ok[0])
    # the silence-host clip (row 2) came from a different RobustEmbedder
    # session (nonce pinned in the fixture); constraining to the loud-host
    # session's nonce must reject it while still accepting clips 0/1.
    # (The nonce is the fixture's pinned value, NOT read back from the
    # hard-pass outputs -- whether row 0 decodes hard vs scl is
    # rounding-adjacent, VERDICT r2 weak #2.)
    v = bv.verify_batch(clips[:3], nv[:3], expected_nonce=b"sessionA")
    assert bool(v[0]) and bool(v[1]) and not bool(v[2])


def test_scl_deep_seg_override_parity(key32, monkeypatch):
    """ECHOSEAL_SCL_DEEP_SEG changes the compiled structure, not results."""
    import jax.numpy as jnp

    from echoseal_tpu.ops.polar import encode_np, polar_spec
    from echoseal_tpu.ops import scl as scl_mod

    spec = polar_spec()
    rng = np.random.default_rng(5)
    bits = np.stack([encode_np(rng.bytes(55), spec) for _ in range(4)])
    y = (2.0 * bits - 1.0) + 0.3 * rng.standard_normal(bits.shape)
    llr = jnp.asarray((2.0 * y / 0.09).astype(np.float32))

    outs = []
    for seg in ("1", "16"):
        monkeypatch.setenv("ECHOSEAL_SCL_DEEP_SEG", seg)
        scl_mod._scl_decode_lazy.clear_cache()
        outs.append(scl_mod._scl_decode_lazy(llr, spec, 8))
    monkeypatch.delenv("ECHOSEAL_SCL_DEEP_SEG")
    scl_mod._scl_decode_lazy.clear_cache()
    np.testing.assert_array_equal(np.asarray(outs[0]["crc_ok"]),
                                  np.asarray(outs[1]["crc_ok"]))
    np.testing.assert_allclose(
        np.minimum(np.asarray(outs[0]["metrics"]), 1e29),
        np.minimum(np.asarray(outs[1]["metrics"]), 1e29), rtol=0, atol=0)


def test_v2_shard_map_verify_multidevice(key32, v2_batch):
    """Sharded v2 (flagship-tier) verify over the 8-virtual-device mesh.

    Mirrors parallel/dryrun.py's v2 leg (VERDICT r3 Missing #2): clips
    split over the streams axis, tables replicated, psum CRC count --
    then the FULL host escalation ladder (futility gate -> staged SCL
    -> extended counters) runs unchanged on the sharded outputs with
    strict per-clip verdicts, including the no-watermark rejection.
    """
    import jax

    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.parallel.mesh import shard_verify_v2, streams_mesh

    clips, nv = v2_batch
    clips8 = np.concatenate([clips, clips])      # 8 rows = 1 per device
    nv8 = np.concatenate([nv, nv])
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    run = shard_verify_v2(bv, streams_mesh())
    out = run(clips8, nv8)
    jax.block_until_ready(out)
    assert out["host_packed"].shape == (8, 65)   # evidence bytes shipped
    v = bv._finish_ladder(out, None, True, 1 << 20)
    assert v.tolist() == [True, True, True, False] * 2


def test_futility_gate_skips_headerless_clips(key32, v2_batch, monkeypatch):
    """Clips with no readable header never enter the escalation ladder.

    Serving clips are mid-stream cuts: the frame counter comes from the
    16-bit header, so a clip where NO candidate row reads a header
    cannot be rescued by SCL escalation or the extended-counter pass
    (both decode against a counter-derived PN).  The gate makes
    rejection cost ~the hard pass alone (VERDICT r3 weak #2: 30+ s of
    pure waste per 1k hopeless clips).  Calibration:
    benchmarks/ladder_profile.py -- every escalation-rescued clip had
    a readable header (rescued hdr_frac 1.0); best-row |LLR| does NOT
    separate the populations, so the q-floor valve is off by default.
    """
    import echoseal_tpu.models.pipeline as pl

    clips, nv = v2_batch
    bv = pl.RobustBatchVerifier(key32, max_ctr=4096)

    seen_pending: list[np.ndarray] = []
    orig = pl.RobustBatchVerifier._scl_fallback

    def spy(self, out, pending, expected_nonce, details=None):
        seen_pending.append(pending.copy())
        return orig(self, out, pending, expected_nonce, details=details)

    monkeypatch.setattr(pl.RobustBatchVerifier, "_scl_fallback", spy)
    v = bv.verify_batch(clips, nv)
    assert v.tolist() == [True, True, True, False]
    # the SCL fallback ran (rows 1/2 need it) but the headerless noise
    # row was gated out of every escalation dispatch
    assert seen_pending and all(not p[3] for p in seen_pending)

    # a batch of pure noise must skip the ladder entirely: no SCL call
    seen_pending.clear()
    rng = np.random.default_rng(7)
    noise = (0.05 * rng.standard_normal(clips.shape)).astype(np.float32)
    assert not bv.verify_batch(noise, nv).any()
    assert seen_pending == []


def test_futility_valve_escalates_headerless_clips(key32, v2_batch,
                                                   monkeypatch):
    """``futility_qfloor=0.0`` restores the pre-gate ladder.

    Evidence parsing is monkeypatched to 'no header read anywhere' AND
    the near-start auto-rescue is disabled, so the gate's behavior
    without either escape hatch is pinned deterministically: the
    default gate drops the SCL-needing clips, the valve-open verifier
    rescues them from the SAME device outputs.  (The auto-rescue path
    itself is pinned by test_near_start_headerless_auto_rescue.)
    """
    import echoseal_tpu.models.pipeline as pl

    clips, nv = v2_batch

    def no_headers(self, raw):
        n = raw.shape[0]
        return np.zeros(n, bool), np.full(n, 1.0, np.float32)

    monkeypatch.setattr(pl.RobustBatchVerifier, "_parse_evidence",
                        no_headers)
    monkeypatch.setattr(pl.RobustBatchVerifier, "_near_start_mask",
                        lambda self, out: np.zeros(4, bool))
    gated = pl.RobustBatchVerifier(key32, max_ctr=4096)
    # with every header masked the default gate blocks ALL escalation:
    # the full ladder decays to the hard pass (rows 1/2 need SCL and
    # are dropped)
    hard = gated.verify_batch(clips, nv, use_scl=False)
    # row 2 (AWGN, ~6 dB under the hard envelope) is SCL-only on every
    # platform; rows 0/1 have rounding-adjacent hard margins, so the
    # binding check is hard-pass equality, not a fixed verdict list
    assert not hard[2]
    assert gated.verify_batch(clips, nv).tolist() == hard.tolist()
    valve = pl.RobustBatchVerifier(key32, max_ctr=4096,
                                   futility_qfloor=0.0)
    assert valve.verify_batch(clips, nv).tolist() == [
        True, True, True, False]


def test_near_start_headerless_auto_rescue(key32, v2_batch, monkeypatch):
    """Headerless NEAR-START clips re-enter SCL escalation automatically.

    VERDICT r4 next #5: the fixture clips start at stream t=0 (the
    from-start, payload-decodable corner -- their counters resolve via
    the time-estimate fallback, the reference's rtwm/detector.py:
    122-142 logic), so when every header read is masked off the
    frame-lattice consistency detector must route them back into the
    SCL ladder without the manual ``futility_qfloor`` valve.  Row 2 is
    SCL-only, so the auto-rescue is load-bearing for its accept.  The
    hopeless-noise rejection cost stays unchanged: a pure-noise batch
    must still never reach an SCL dispatch (spied below) -- noise
    peak phases are uniform mod FRAME_LEN, and the Rayleigh tail puts
    P(concentration >= 0.8 | n=16) at ~4e-5.
    """
    import echoseal_tpu.models.pipeline as pl

    clips, nv = v2_batch

    def no_headers(self, raw):
        n = raw.shape[0]
        return np.zeros(n, bool), np.full(n, 1.0, np.float32)

    monkeypatch.setattr(pl.RobustBatchVerifier, "_parse_evidence",
                        no_headers)
    bv = pl.RobustBatchVerifier(key32, max_ctr=4096)

    seen_pending: list[np.ndarray] = []
    orig = pl.RobustBatchVerifier._scl_fallback

    def spy(self, out, pending, expected_nonce, details=None):
        seen_pending.append(pending.copy())
        return orig(self, out, pending, expected_nonce, details=details)

    monkeypatch.setattr(pl.RobustBatchVerifier, "_scl_fallback", spy)
    assert bv.verify_batch(clips, nv).tolist() == [True, True, True, False]
    # the watermarked near-start rows escalated; the no-watermark noise
    # row never did (its peaks are off-lattice)
    assert seen_pending and all(not p[3] for p in seen_pending)

    seen_pending.clear()
    rng = np.random.default_rng(11)
    noise = (0.05 * rng.standard_normal(clips.shape)).astype(np.float32)
    assert not bv.verify_batch(noise, nv).any()
    assert seen_pending == []


def test_near_start_mask_math():
    """The lattice-consistency detector's three gates, on synthetic peaks.

    (a) lattice-aligned near-start peaks -> escalate; (b) uniform-phase
    noise peaks -> gated; (c) lattice-aligned but first peak past the
    wide window (mid-stream cut can't time-resolve a counter) -> gated.
    """
    from echoseal_tpu.core.params import WIDE_DELTA
    from echoseal_tpu.core.profiles import ROBUST
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    span = ROBUST.span                        # v2 frame pacing in samples
    P = 4
    idx = np.zeros((3, 4, P), np.int32)
    val = np.zeros((3, 4, P), np.float32)
    rng = np.random.default_rng(0)
    # (a) frames 0..15 on the exact lattice, +-2 sample jitter
    ctrs = np.arange(16).reshape(4, P)
    idx[0] = ctrs * span + rng.integers(-2, 3, (4, P))
    # (b) uniform random positions
    idx[1] = rng.integers(0, 300 * span, (4, P))
    # (c) lattice-aligned, but every counter estimate >= WIDE_DELTA
    idx[2] = (WIDE_DELTA + ctrs) * span + rng.integers(-2, 3, (4, P))
    out = {"peak_idx": idx, "peak_val": val}
    bv = object.__new__(RobustBatchVerifier)  # mask needs span only
    bv.span = span
    mask = bv._near_start_mask(out)
    assert mask.tolist() == [True, False, False]


def test_staged_scl_ladder_verdict_parity(key32, v2_batch, monkeypatch):
    """L=8->32 staged SCL fallback verdict-matches the fixed-L decode.

    Rescue is a disjunction over (row, L) attempts whose final rung is
    the configured list size, so staging can only grow the rescue set;
    accepts stay AEAD-gated.  Pinned here by running the same batch
    with the ladder disabled (fixed L only).
    """
    import echoseal_tpu.models.pipeline as pl

    clips, nv = v2_batch
    bv = pl.RobustBatchVerifier(key32, max_ctr=4096)
    staged = bv.verify_batch(clips, nv)
    monkeypatch.setattr(pl, "SCL_LADDER", ())
    fixed = bv.verify_batch(clips, nv)
    assert staged.tolist() == fixed.tolist() == [True, True, True, False]


def test_parse_evidence_compat_width():
    """Compat-width (60-byte) host rows parse as 'always has evidence'.

    The monitor and retry paths can hand `_finish_ladder` rows without
    the v2 evidence bytes; the gate must fail OPEN (never drop a clip
    for lack of instrumentation).
    """
    from types import SimpleNamespace

    from echoseal_tpu.core.profiles import ROBUST, profile_spec
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    fake = SimpleNamespace(_spec=profile_spec(ROBUST))
    raw = np.zeros((3, 60), np.uint8)
    hdr, q = RobustBatchVerifier._parse_evidence(fake, raw)
    assert hdr.all() and np.isinf(q).all()


def test_robust_batch_past_pn_table_ceiling(key32):
    """v2 serving resolves clips cut past the PN table, like compat.

    (Round-2 review finding: the escalation existed only for compat; a v2
    clip cut >~55 min into a session verified single-clip but was silently
    rejected by the batch tier.)
    """
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder

    T = int(3.5 * FS)
    Tpad = 1 << 18
    tx = RobustEmbedder(key32)
    tx.frame_ctr = 70_000                  # ~29.5 min of v2 stream, > 2**16
    wm = tx.process(np.zeros(T, np.float32))
    clips = np.zeros((1, Tpad), np.float32)
    clips[0, :T] = wm
    nv = np.full(1, T, np.int32)
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    out = bv.run_device(clips, nv)
    v, _ = bv.finish_host_detailed(out)
    assert not v.any()                     # table pass alone misses
    assert bv.verify_batch(clips, nv).all()


def test_v2_extended_counter_deep_stream(key32):
    """Multi-hour counters resolve through the vectorised ext-ctr fan-out.

    VERDICT r4 weak #7: the multiplier enumeration was a quadruple
    Python loop with no deep-stream evidence.  Three clips cut at
    ~0.5 h / ~2.5 h / ~6.9 h of v2 stream (multipliers 1, 8, and 23 of
    the lo16 + m*2^16 ladder) must all verify in ONE batch against a
    small PN table, and the wrong-session replay must still reject.
    """
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder

    T = int(3.5 * FS)
    Tpad = 1 << 18
    ctrs = (70_000, 530_000, 1_510_000)
    clips = np.zeros((len(ctrs), Tpad), np.float32)
    for r, c in enumerate(ctrs):
        tx = RobustEmbedder(key32)
        tx._session_nonce = b"deepstrm"
        tx.frame_ctr = c
        clips[r, :T] = tx.process(np.zeros(T, np.float32))
    nv = np.full(len(ctrs), T, np.int32)
    bv = RobustBatchVerifier(key32, max_ctr=4096)
    assert bv.verify_batch(
        clips, nv, max_stream_frames=1 << 21,
        expected_nonce=b"deepstrm").all()
    assert not bv.verify_batch(
        clips, nv, max_stream_frames=1 << 21,
        expected_nonce=b"other!!!").any()
