"""Robust (v2) waveform: oversampled-chip TX and verifier.

Same crypto, frame layout (63/128/1024 chips), hop schedule, payload
format and mixing law as the compat path -- but each chip is HELD for
``profile.oversample`` samples before the band-pass, concentrating its
energy in band, and the polar info set follows the standard convention.
The result survives real channels (loud hosts, MP3-style codecs, moderate
noise) that the reference wire format physically cannot
(core/profiles.py).

The receiver reuses the chip-domain machinery end-to-end: LS demod against
the oversampled forward model, then the SAME header decode / LLR / SCL /
AEAD chain as compat -- only the demod matrices and sync templates change.
"""
from __future__ import annotations

import functools
import secrets
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla
from scipy.signal import lfilter

from echoseal_tpu.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_tpu.core.crypto import SecureChannel
from echoseal_tpu.core.params import (
    EPS,
    FRAME_LEN,
    HDR_L,
    MAGIC,
    MIX_HEADROOM,
    PRE_L,
    TxParams,
)
from echoseal_tpu.core.profiles import ROBUST, WaveformProfile, profile_spec
from echoseal_tpu.core.sequences import bits_to_bpsk, header_bits, mls63
from echoseal_tpu.models.detector import VerifyResult, resample_to
from echoseal_tpu.models.embedder import db_to_lin
from echoseal_tpu.ops import demod, filters
from echoseal_tpu.ops.polar import encode_np, hard_decode_batch, pack_info_bits
from echoseal_tpu.ops.scl import scl_decode
from echoseal_tpu.utils.logging import get_logger
from echoseal_tpu.utils.transfer import host_fetch

_LOG = get_logger("rx.v2")

MIN_CLIP_SECONDS = 3.0
# LS regularisation ladder for the oversampled model: the in-band energy
# concentration makes conditioning mild, so two profiles suffice
LAM_PROFILES = (1e-6, 1e-3)


def resolve_table_dtype(table_dtype: str | None):
    """Storage dtype for the (378 MB at S=8) v2 LS demod tables.

    ``None`` means ``"f32"`` on every backend.  ``"bf16"`` halves the
    tables' device memory and upload; compute is unaffected (the demod
    einsum promotes the table back to float32 on device), so the only
    numerical effect is the one-time ~0.4% relative quantisation of the
    table entries, measured verdict-identical across the impairment
    corpus (the v2 LS inversion is mild by design; the COMPAT tier keeps
    f32 everywhere because its exact inversion amplifies quantisation --
    see ops/demod.py).
    """
    if table_dtype is None:
        table_dtype = "f32"
    if table_dtype not in ("f32", "bf16"):
        raise ValueError(f"table_dtype must be 'f32' or 'bf16', "
                         f"got {table_dtype!r}")
    return jnp.bfloat16 if table_dtype == "bf16" else jnp.float32


# --------------------------------------------------------------- host model
@lru_cache(maxsize=32)
def _chip_pulse(lo: float, hi: float, fs: int, S: int, span: int) -> np.ndarray:
    """Zero-state filtered S-sample box pulse, length ``span``."""
    b, a = filters.butter_coeffs(lo, hi, fs)
    box = np.zeros(span)
    box[:S] = 1.0
    return lfilter(b, a, box)


@lru_cache(maxsize=32)
def robust_demod_matrix(lo: float, hi: float, fs: int, S: int,
                        lam: float) -> np.ndarray:
    """(FRAME_LEN, span) float32 LS chip-recovery matrix."""
    span = FRAME_LEN * S
    g = _chip_pulse(lo, hi, fs, S, span)
    T = np.zeros((span, FRAME_LEN))
    for j in range(FRAME_LEN):
        L = span - j * S
        T[j * S :, j] = g[:L]
    A = T.T @ T + lam * np.eye(FRAME_LEN)
    M = sla.cho_solve(sla.cho_factor(A), T.T)
    return M.astype(np.float32)


@lru_cache(maxsize=8)
def robust_templates(fs: int, S: int) -> np.ndarray:
    """(4, 63*S) unit-norm sync templates (filtered oversampled MLS)."""
    pre = np.repeat(bits_to_bpsk(mls63(), dtype=np.float64), S)
    out = []
    for lo, hi in BAND_PLAN:
        b, a = filters.butter_coeffs(lo, hi, fs)
        t = lfilter(b, a, pre)
        out.append((t / (np.linalg.norm(t) + 1e-12)).astype(np.float32))
    return np.stack(out)


# -------------------------------------------------- time-scale recovery
# The 504-sample (S=8) preamble loses sync coherence past ~0.25% residual
# time scale, so an UNKNOWN +-5% playback-speed change hides the watermark
# completely.  Recovery is a sync-only scaled-template scan: one bank of
# preamble templates, each resampled for a candidate correction factor
# (grid step 0.33% keeps the worst-case residual ~0.17%, inside coherence)
# x 4 bands, correlated against the clip in a single device conv.  The
# winning factor is refined by the inter-peak spacing estimator (frame
# spacing = span / factor, ~5e-5 resolution) and ONE corrective resample
# makes the frame coherent for the normal pipeline.  Cost when triggered:
# one conv dispatch + two host resamples.
SCALE_SCAN_GRID = tuple(np.round(np.linspace(0.95, 1.05, 31), 5))


@lru_cache(maxsize=8)
def scaled_template_bank(fs: int, S: int,
                         factors: tuple = SCALE_SCAN_GRID) -> np.ndarray:
    """(len(factors)*4, Lmax) zero-padded unit-norm scaled sync templates.

    Row ``i*4 + b`` = band-``b`` template as it appears after a playback
    at channel factor ``1/factors[i]`` (i.e. the clip that CORRECTION
    factor ``factors[i]`` would fix).
    """
    base = robust_templates(fs, S).astype(np.float64)
    rows = []
    for r in factors:
        for b in range(4):
            t = resample_to(fs, base[b], int(round(fs / r)))
            rows.append(t / (np.linalg.norm(t) + 1e-12))
    L = max(t.size for t in rows)
    bank = np.zeros((len(rows), L), np.float32)
    for i, t in enumerate(rows):
        bank[i, : t.size] = t
    return bank


@jax.jit
def _scale_scan_stage(x: jnp.ndarray, n_valid: jnp.ndarray,
                      bank: jnp.ndarray) -> jnp.ndarray:
    """Max normalized sync correlation per bank row -> (rows,) float32.

    FFT correlation, not conv: the bank has ~124 rows, and one rfft of the
    clip + per-row spectral products is ~50x cheaper than the implicit-GEMM
    conv here (this is also the only correlation in the codebase whose
    kernel count makes the FFT side of the tradeoff win -- see
    demod.normalized_xcorr for the conv-is-faster case).  The sliding
    window energy is a cumsum difference, O(T).  Callers pad ``x`` to a
    power of two >= clip + bank length, so circular wrap-around lags are
    already masked by ``n_valid``.
    """
    T = x.shape[-1]
    L = bank.shape[-1]
    X = jnp.fft.rfft(x)
    Bf = jnp.fft.rfft(bank, T)                      # (rows, T//2+1)
    corr = jnp.fft.irfft(X[None, :] * jnp.conj(Bf), T)[:, : T - L + 1]
    e = jnp.cumsum(x * x)
    ew = e[L - 1:] - jnp.concatenate([jnp.zeros(1, x.dtype), e[: -L]])
    energy = jnp.sqrt(jnp.maximum(ew, 0.0)) + 1e-12
    corr = corr / energy[None, : T - L + 1]
    lag = jnp.arange(corr.shape[-1])
    ok = lag[None, :] <= (n_valid - L)
    return jnp.max(jnp.where(ok, corr, -jnp.inf), axis=-1)


@functools.partial(jax.jit, static_argnames=("row_chunk",))
def _scale_scan_batch(x: jnp.ndarray, n_valid: jnp.ndarray,
                      bank: jnp.ndarray, row_chunk: int = 4) -> jnp.ndarray:
    """``_scale_scan_stage`` for a clip BATCH: (B, T) -> (B, rows).

    One rfft of the whole batch, then a ``lax.scan`` over bank-row chunks
    so the (B, chunk, T) correlation intermediate stays bounded (~170 MB
    at B=128, chunk=4, T=160k) instead of materializing the full
    (B, 124, T) cube.  Replaces a one-dispatch-per-failing-clip loop in
    ``RobustBatchVerifier.verify_batch_recover``, where each dispatch
    paid a fixed overhead plus a 640 KB clip upload.
    """
    B, T = x.shape
    R, L = bank.shape
    X = jnp.fft.rfft(x)                              # (B, T//2+1)
    e = jnp.cumsum(x * x, axis=-1)
    ew = e[:, L - 1:] - jnp.concatenate(
        [jnp.zeros((B, 1), x.dtype), e[:, :-L]], axis=-1)
    energy = jnp.sqrt(jnp.maximum(ew, 0.0)) + 1e-12  # (B, T-L+1)
    lag = jnp.arange(T - L + 1)
    ok = lag[None, :] <= (n_valid[:, None] - L)      # (B, T-L+1)
    Bf = jnp.conj(jnp.fft.rfft(bank, T))             # (R, T//2+1)
    pad = (-R) % row_chunk
    Bf = jnp.pad(Bf, ((0, pad), (0, 0)))

    def step(_, bc):                                 # bc: (chunk, T//2+1)
        corr = jnp.fft.irfft(X[:, None, :] * bc[None], T,
                             axis=-1)[..., : T - L + 1]
        corr = corr / energy[:, None, :]
        best = jnp.max(jnp.where(ok[:, None, :], corr, -jnp.inf), axis=-1)
        return None, best                            # (B, chunk)

    _, scores = jax.lax.scan(
        step, None, Bf.reshape(-1, row_chunk, Bf.shape[-1]))
    return jnp.moveaxis(scores, 0, 1).reshape(B, -1)[:, :R]


# Minimum |fine - 1| at which a chained refinement acts on the spacing
# estimate.  This was 1e-4, which silently masked the retry lattice's own
# quantization: for true playback factor s the best RETRY_UP=12000
# rational can sit up to ~4e-5 off 1/s, and the SCAN grid pick up to a
# full lattice step (~8.3e-5) off -- e.g. s=1.031: grid 0.97 leaves
# residual +7.0e-5 while the ADJACENT lattice point 11639/12000 leaves
# -1.6e-5.  Clips whose start phase cannot tolerate ~7e-5 of chip drift
# then failed with the refiner abstaining (measured: 50/51 residual
# failures in benchmarks/timescale_attrib.py had the correct coarse
# factor tried and still lost).  2.5e-5 sits just above the spacing
# estimator's per-clip noise floor (~1e-5: sample-quantized spacings at
# k>=4 frame baselines, median over >=2 ratios) so near-zero residuals
# rarely spawn spurious retries, while every masked lattice residual is
# actionable; retries are deduped on the lattice and bounded by the
# refinement depth, so the worst case is one extra bucketed re-verify.
FINE_CHAIN_MIN = 2.5e-5


def estimate_timescale_from_peaks(peaks: np.ndarray | None,
                                  span: int) -> float | None:
    """Modal scale ratio from same-band sync-peak spacings.

    Observed frame spacing d = k * span / residual_factor; a >=2-frame
    baseline pins the residual to ~5e-5 -- well inside the demod window's
    ~2e-4 chip-coherence limit.  ``peaks``: (4, K) sample positions, -1 for
    invalid.  Returns None when fewer than 2 plausible spacings exist.
    """
    if peaks is None:
        return None
    ratios = []
    for b in range(peaks.shape[0]):
        pos = np.sort(peaks[b][peaks[b] >= 0])
        for d in np.diff(pos):
            k = int(round(d / span))
            if k >= 1 and abs(d / (k * span) - 1.0) < 0.06:
                ratios.append(d / (k * span))
    if len(ratios) < 2:
        return None
    return float(np.median(ratios))


# ------------------------------------------------------------------ TX side
class RobustEmbedder:
    """Streaming v2 watermark mixer (same `process` surface as compat)."""

    def __init__(self, key32: bytes, params: TxParams | None = None,
                 profile: WaveformProfile = ROBUST) -> None:
        self.p = params or TxParams()
        self.profile = profile
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self._spec = profile_spec(profile)
        self.frame_ctr = 0
        self._chip_buf = np.empty(0, dtype=np.float32)
        self._session_nonce = secrets.token_bytes(8)
        self._preamble_sy = bits_to_bpsk(self.p.preamble)
        self._hdr_pn_sy = bits_to_bpsk(self.sec.pn_bits(0, HDR_L))

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = np.asarray(samples).astype(np.float32, copy=False)
        in_rms = float(np.sqrt(np.mean(x * x)) + EPS) if x.size else EPS
        while self._chip_buf.size < x.size:
            self._chip_buf = np.concatenate(
                (self._chip_buf, self._make_frame()))
            self.frame_ctr = (self.frame_ctr + 1) % (2**32)
        chips = self._chip_buf[: x.size]
        self._chip_buf = self._chip_buf[x.size :]
        scale = max(db_to_lin(self.p.target_rel_db) * in_rms,
                    db_to_lin(self.p.floor_rel_dbfs))
        headroom = max(MIX_HEADROOM - float(np.max(np.abs(x), initial=0.0)),
                       0.0)
        peak = float(np.max(np.abs(chips), initial=0.0)) + EPS
        scale = min(scale, headroom / peak) if peak > 0.0 else 0.0
        return x + chips * scale

    def embed(self, host: np.ndarray,
              session_nonce: bytes | None = None) -> np.ndarray:
        if session_nonce is not None:
            self._session_nonce = session_nonce
        return self.process(host)

    def _make_frame(self) -> np.ndarray:
        S = self.profile.oversample
        ctr = self.frame_ctr
        band = self._hop.band(ctr)
        # sealed blob = AEAD nonce(12) + meta + tag(16) must land exactly
        # on the spec's payload width; at K=448 that is 11 random-pad
        # bytes, at the K=360 floor (low-rate profiles) zero
        pad = self._spec.info_len // 8 - 28 - 16
        meta = (MAGIC + ctr.to_bytes(4, "big") + self._session_nonce
                + secrets.token_bytes(pad))
        payload = self.sec.seal(meta)
        data_sy = bits_to_bpsk(encode_np(payload, self._spec))
        hdr_sy = bits_to_bpsk(header_bits(ctr)) * self._hdr_pn_sy
        pn = self.sec.pn_bits(ctr, FRAME_LEN)[PRE_L + HDR_L :]
        spread = data_sy * bits_to_bpsk(pn)
        sym = np.concatenate([self._preamble_sy, hdr_sy, spread])
        up = np.repeat(sym.astype(np.float64), S)
        b, a = filters.butter_coeffs(band[0], band[1], self.p.fs)
        chips = lfilter(b, a, up)
        peak = float(np.max(np.abs(chips))) + EPS
        if peak > 3.0:
            chips = chips / peak
        return chips.astype(np.float32)


# ------------------------------------------------------------------ RX side
@functools.partial(jax.jit, static_argnames=("span", "peaks"))
def _robust_scan(x, n_valid, templates, m_stack, hdr_pn_sy, pre_sy,
                 span: int, peaks: int = 4):
    """Sync + demod + header for a v2 clip.  m_stack: (4, P, 1215, span)."""
    T = x.shape[-1]
    corr = demod.normalized_xcorr(x, templates)
    lag = jnp.arange(corr.shape[-1])
    corr = jnp.where(lag[None, :] <= n_valid - span, corr, -jnp.inf)
    idx, val = demod.topk_nms(corr, peaks, span // 2)        # (4, K)

    starts = jnp.clip(idx, 0, T - span)
    win = demod.slice_windows(x, starts, span)               # (4, K, span)
    win = win * jax.lax.rsqrt(jnp.mean(win * win, -1, keepdims=True) + 1e-30)

    chips = jnp.einsum("bnw,bpkw->bpnk", win, m_stack,
                       precision=jax.lax.Precision.HIGHEST)  # (4,P,K,1215)
    pre = demod.preamble_score(chips, pre_sy)
    hdr_ok, lo16, hdr_score = demod.header_decode(chips, hdr_pn_sy)
    return dict(peak_idx=idx, peak_val=val, chips=chips, pre=pre,
                hdr_ok=hdr_ok, hdr_lo16=lo16, hdr_score=hdr_score)


class RobustVerifier:
    """Single-clip v2 verifier (same verify surface as WatermarkDetector)."""

    def __init__(self, key32: bytes, *, fs_target: int | None = None,
                 list_size: int | None = None,
                 profile: WaveformProfile = ROBUST,
                 timescale_grid: tuple[float, ...] | None = None,
                 table_dtype: str | None = None,
                 params=None) -> None:
        # RxParams may supply fs_target / list_size / timescale_grid
        # defaults (explicit kwargs win); the compat detector reads the
        # same container, so one config object drives both tiers
        if params is not None:
            if list_size is None:
                list_size = params.list_size
            if timescale_grid is None and params.timescale_grid:
                timescale_grid = params.timescale_grid
            if fs_target is None:
                fs_target = params.fs_target
        if fs_target is None:
            fs_target = 48_000
        if list_size is None:
            list_size = 32
        if timescale_grid is None:
            timescale_grid = (1.0,)
        self.profile = profile
        self.fs_target = fs_target
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self._spec = profile_spec(profile)
        self._list_size = int(list_size)
        self.session_nonce: bytes | None = None
        self.timescale_grid = timescale_grid

        S = profile.oversample
        self._templates = jnp.asarray(robust_templates(fs_target, S))
        m = np.stack([
            np.stack([robust_demod_matrix(lo, hi, fs_target, S, lam)
                      for lam in LAM_PROFILES])
            for lo, hi in BAND_PLAN
        ])
        self._m_stack = jnp.asarray(m, dtype=resolve_table_dtype(table_dtype))
        self._pre_sy = jnp.asarray(bits_to_bpsk(mls63()))
        self._hdr_pn_sy = jnp.asarray(bits_to_bpsk(self.sec.pn_bits(0, HDR_L)))

    def verify(self, audio: np.ndarray, fs_in: int) -> bool:
        return self.verify_detailed(audio, fs_in).authentic

    def verify_detailed(self, audio: np.ndarray, fs_in: int) -> VerifyResult:
        signal = resample_to(self.fs_target, audio, fs_in)
        if signal.size < int(MIN_CLIP_SECONDS * self.fs_target):
            return VerifyResult(False, stage=None)
        res = self._verify_once(signal)
        if res.authentic:
            _LOG.event("verdict", authentic=True, stage=res.stage,
                       tries=res.tries, ctr=res.frame_ctr)
            return res

        # ---- time-scale recovery ladder ---------------------------------
        # The demod window loses chip coherence past ~2e-4 residual scale
        # while sync peaks stay visible to ~2.5e-3 (ROADMAP measurement),
        # so EVERY coarse correction chains one inter-peak-spacing
        # refinement: coarse gets the peaks to show, the spacing estimator
        # (frame spacing = k*span/residual, ~5e-5 resolution on a >=2-frame
        # baseline) pins the true factor, one more resample verifies.
        # Coarse candidates, cheapest first: the unscaled clip's own peaks
        # (residual already <~0.25%), the caller grid (API compat), then
        # the sync-only scaled-template scan (unknown +-5%, no hint).
        tried = {1.0}
        for factor in self._correction_candidates(signal, res):
            f = round(float(factor), 6)
            if f in tried:
                continue
            tried.add(f)
            r = self._verify_scaled(signal, f)
            if r.authentic:
                _LOG.event("verdict", authentic=True, stage=r.stage,
                           timescale=r.timescale, ctr=r.frame_ctr)
                return r
            fine = self._estimate_timescale(r.peaks)
            if fine is not None and abs(fine - 1.0) > FINE_CHAIN_MIN:
                f2 = round(f * fine, 6)
                if f2 not in tried:
                    tried.add(f2)
                    r = self._verify_scaled(signal, f2)
                    if r.authentic:
                        _LOG.event("verdict", authentic=True, stage=r.stage,
                                   timescale=r.timescale, ctr=r.frame_ctr)
                        return r
        _LOG.event("verdict", authentic=False, tried=sorted(tried))
        return VerifyResult(False, stage=None)

    def _correction_candidates(self, signal: np.ndarray, res0):
        """Lazy coarse correction factors for the recovery ladder."""
        fine0 = self._estimate_timescale(res0.peaks)
        if fine0 is not None and abs(fine0 - 1.0) > FINE_CHAIN_MIN:
            yield fine0
        for f in self.timescale_grid:
            if f != 1.0:
                yield f
        est = self.estimate_scale(signal)
        if est is not None and abs(est - 1.0) > 1e-4:
            yield est

    def _verify_scaled(self, signal: np.ndarray, factor: float) -> "VerifyResult":
        sig = resample_to(self.fs_target, signal,
                          int(round(self.fs_target * factor)))
        res = self._verify_once(sig)
        res.timescale = factor
        return res

    def estimate_scale(self, signal: np.ndarray) -> float | None:
        """Sync-only scan: best correction factor in [0.95, 1.05] or None.

        One device dispatch correlates the clip against the full scaled
        template bank, pinning the playback-speed correction to the grid
        step (~0.33%), inside the preamble's sync-coherence range.  The
        gate is deliberately loose (measured: a true-factor watermark under
        a 10x host scores ~0.06 vs a ~0.044 wrong-factor floor, ~3 MADs on
        a 31-sample scan): a false estimate costs one wasted verify pass,
        a missed true one costs the clip.
        """
        S = self.profile.oversample
        bank = scaled_template_bank(self.fs_target, S)
        T = signal.size
        Tpad = 1 << max(17, (T + bank.shape[-1] - 1).bit_length())
        x = np.zeros(Tpad, dtype=np.float32)
        x[:T] = signal
        score = np.asarray(_scale_scan_stage(
            jnp.asarray(x), jnp.int32(T), jnp.asarray(bank)))
        per_factor = score.reshape(len(SCALE_SCAN_GRID), 4).max(axis=1)
        med = np.median(per_factor)
        mad = np.median(np.abs(per_factor - med)) + 1e-9
        best = int(np.argmax(per_factor))
        if per_factor[best] < max(med + 2.0 * 1.4826 * mad, 1.15 * med):
            return None
        return float(SCALE_SCAN_GRID[best])

    def _estimate_timescale(self, peaks: np.ndarray | None) -> float | None:
        return estimate_timescale_from_peaks(peaks, self.profile.span)

    def _verify_once(self, signal: np.ndarray) -> "VerifyResult":
        span = self.profile.span
        T = signal.size
        Tpad = 1 << max(17, (T + span - 1).bit_length())
        x = np.zeros(Tpad, dtype=np.float32)
        x[:T] = signal
        out = _robust_scan(jnp.asarray(x), jnp.int32(T), self._templates,
                           self._m_stack, self._hdr_pn_sy, self._pre_sy,
                           span=span)
        out = host_fetch(out)   # ONE download for the whole stage dict
        peaks = np.where(np.isfinite(out["peak_val"]), out["peak_idx"], -1)

        nb, npf, nk, _ = out["chips"].shape
        rows = []   # (band, prof, k, ctr)
        for b in range(nb):
            for k in range(nk):
                start = int(out["peak_idx"][b, k])
                ctr_est = int(round(start / span))
                for p in range(npf):
                    lo16 = int(out["hdr_lo16"][b, p, k])
                    cands = []
                    if out["hdr_ok"][b, p, k] and self._hop.index(lo16) == b:
                        cands.append(lo16)
                    cands += [c for c in range(max(0, ctr_est - 3),
                                               ctr_est + 4)
                              if self._hop.index(c) == b and c not in cands]
                    for c in cands:
                        rows.append((b, p, k, c))
        if not rows:
            return VerifyResult(False, stage=None, peaks=peaks)

        bands = np.array([r[0] for r in rows])
        profs = np.array([r[1] for r in rows])
        ks = np.array([r[2] for r in rows])
        ctrs = np.array([r[3] for r in rows], dtype=np.int64)
        chips = out["chips"][bands, profs, ks].astype(np.float32)
        uniq, inv = np.unique(ctrs, return_inverse=True)
        pn = self.sec.pn_bits_batch(uniq, FRAME_LEN)[:, PRE_L + HDR_L :]
        pn_sy = 2.0 * pn[inv].astype(np.float32) - 1.0

        llr_dev = demod.payload_llr(jnp.asarray(chips), jnp.asarray(pn_sy))
        info_dev, crc_dev = hard_decode_batch(llr_dev, self._spec)
        # one download (llr feeds the SCL selection below; keeping it on
        # device and re-fetching per stage would pay the link RTT thrice)
        llr, info, crc_ok = host_fetch((llr_dev, info_dev, crc_dev))
        for i in np.flatnonzero(crc_ok):
            if self._accept(info[i], int(ctrs[i])):
                return VerifyResult(True, frame_ctr=int(ctrs[i]),
                                    band=BAND_PLAN[bands[i]],
                                    peak_pos=int(out["peak_idx"][
                                        bands[i], ks[i]]),
                                    stage="hard", tries=int(i) + 1,
                                    peaks=peaks)

        # SCL pass over the best rows
        quality = np.mean(np.abs(llr), axis=-1)
        sel = np.argsort(-quality, kind="stable")[:32]
        res = scl_decode(jnp.asarray(llr[sel]), self._spec, self._list_size)
        ok, bits = host_fetch((res["crc_ok"], res["info_bits"]))
        for rloc, r in enumerate(sel):
            for li in np.flatnonzero(ok[rloc]):
                if self._accept(bits[rloc, li], int(ctrs[r])):
                    return VerifyResult(True, frame_ctr=int(ctrs[r]),
                                        band=BAND_PLAN[bands[r]],
                                        peak_pos=int(out["peak_idx"][
                                            bands[r], ks[r]]),
                                        stage="scl", tries=rloc + 1,
                                        peaks=peaks)
        return VerifyResult(False, stage=None, peaks=peaks)

    def _accept(self, info_bits: np.ndarray, frame_ctr: int) -> bool:
        blob = pack_info_bits(info_bits)
        plain, _ = self.sec.open_any_layout(blob)
        if plain is None or not plain.startswith(MAGIC):
            return False
        if int.from_bytes(plain[4:8], "big") != frame_ctr:
            return False
        nonce = plain[8:16]
        if self.session_nonce is None:
            self.session_nonce = nonce
            return True
        return nonce == self.session_nonce
