"""Frame demodulation as dense linear algebra (the batched receiver).

The reference recovers payload chips with a matched filter plus an integer
chip-phase search (rtwm/detector.py:296-416).  At 48 kHz chip rate through a
2 kHz-wide order-4 Butterworth, inter-chip interference makes per-chip
matched-filter outputs essentially uninformative (sign agreement with the
true codeword ~= 0.51, measured); the committed reference cannot decode its
own frames.  This module replaces that stage with exact linear inversion:

Every frame is synthesised by zero-state band-pass filtering of 1215 BPSK
chips and truncated at the frame boundary (rtwm/embedder.py:137-144), so the
observed window obeys  y = T c  with T a *known* lower-triangular Toeplitz
banded matrix (columns = filter impulse response, clipped at the frame end).
Chip recovery is Tikhonov-regularised least squares

    c_hat = (T^T T + lam I)^{-1} T^T y  =  M y,

with M precomputed per band ONCE on the host in float64 and shipped to the
device as an f32 constant.  Demodulating any number of candidate frames is
then a single matmul: (candidates, W) x (W, 1215).

Two model variants are built:

* ``direct``  -- T from the TX filter alone; window = the 1215 frame
  samples.  Best chip SNR on clean/quiet hosts (out-of-band chip energy is
  usable); fragile when a loud host dominates out of band.
* ``cascade`` -- the stream is band-pass filtered again at RX (like the
  reference detector, rtwm/detector.py:59-60) and T models the TX*RX
  cascade including the TX-side frame truncation; window extends TAIL
  samples past the frame to capture RX-filter tails.  Robust to loud
  out-of-band hosts, ~2x worse chip SNR on clean ones.

The detector scores both and lets the FEC decide.

Why no host-rejection profile exists (measured): T's singular spectrum
for the 18-22 kHz band falls to ~2.5e-6 by index 1100 -- the last ~100
chip dimensions are carried entirely by the LOW-frequency truncation
leakage.  Projecting out <3.6 kHz (where any speech/music host lives)
drops those to ~7e-10 and the exact inversion collapses to chance even on
clean captures.  A host in that band is information-fatal to this wire
format, not a demodulation shortcoming -- use the v2 profile for hosts
(core/profiles.py).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla
from scipy.signal import lfilter

from echoseal_tpu.core.bandplan import BAND_PLAN
from echoseal_tpu.core.params import FRAME_LEN, HDR_L, HDR_BITS, HDR_REPEAT, PRE_L
from echoseal_tpu.core.sequences import bits_to_bpsk, mls63
from echoseal_tpu.ops import filters

# Demod window: direct uses the exact frame; cascade appends the RX tail.
CASCADE_TAIL = 512
W_DIRECT = FRAME_LEN
W_CASCADE = FRAME_LEN + CASCADE_TAIL
# Direct-model profiles: BOTH use the lam=1e-12 exact inversion.  Profile
# 0 is hard-projection REFINED (see refine_chips) -- the hard-decision
# champion on digital-clean clips; profile 1 stays RAW, because the raw LS
# amplitudes carry the per-chip confidence the soft (SCL) pass needs:
# weakly-observed or erased chips come out near 0 -> low |LLR| -> the list
# decoder forks there.  Refinement anchors every chip to +-amp, which
# turns erasures into confidently-WRONG bits that no list size can fix.
LAM_DIRECT_PROFILES = (1e-12, 1e-12)
LAM_CASCADE = 1e-10

# offsets searched around each sync peak (chip-accurate alignment)
SYNC_OFFSETS = (-2, -1, 0, 1, 2)

_IMP_LEN = 8192


@lru_cache(maxsize=32)
def _tx_ir(lo: float, hi: float, fs: int) -> np.ndarray:
    b, a = filters.butter_coeffs(lo, hi, fs)
    imp = np.zeros(_IMP_LEN)
    imp[0] = 1.0
    return lfilter(b, a, imp)


@lru_cache(maxsize=32)
def demod_matrix_direct(lo: float, hi: float, fs: int,
                        lam: float = LAM_DIRECT_PROFILES[0]) -> np.ndarray:
    """(FRAME_LEN, FRAME_LEN) float32 chip-recovery matrix, TX model only."""
    g = _tx_ir(lo, hi, fs)[:FRAME_LEN]
    T = sla.toeplitz(g, np.zeros(FRAME_LEN))
    A = T.T @ T + lam * np.eye(FRAME_LEN)
    M = sla.cho_solve(sla.cho_factor(A), T.T)
    return M.astype(np.float32)


@lru_cache(maxsize=32)
def demod_matrix_cascade(lo: float, hi: float, fs: int,
                         lam: float = LAM_CASCADE,
                         tail: int = CASCADE_TAIL) -> np.ndarray:
    """(FRAME_LEN, FRAME_LEN + tail) float32 matrix for the TX*RX cascade.

    Column j = RX-filtered version of chip j's TX waveform *as truncated at
    the frame boundary* (the embedder cuts each frame's filter tail at 1215
    samples before the next frame begins).
    """
    b, a = filters.butter_coeffs(lo, hi, fs)
    g = _tx_ir(lo, hi, fs)
    W = FRAME_LEN + tail
    T = np.zeros((W, FRAME_LEN))
    for j in range(FRAME_LEN):
        tx_col = g[: FRAME_LEN - j]
        T[j:, j] = lfilter(b, a, np.concatenate(
            [tx_col, np.zeros(W - j - tx_col.size)]))
    A = T.T @ T + lam * np.eye(FRAME_LEN)
    M = sla.cho_solve(sla.cho_factor(A), T.T)
    return M.astype(np.float32)


@lru_cache(maxsize=32)
def forward_matrix_direct(lo: float, hi: float, fs: int) -> np.ndarray:
    """(W_DIRECT, FRAME_LEN) float32 forward model T (chips -> window)."""
    g = _tx_ir(lo, hi, fs)[:FRAME_LEN]
    return sla.toeplitz(g, np.zeros(FRAME_LEN)).astype(np.float32)


def all_forward_matrices(fs: int) -> np.ndarray:
    """(4, W_DIRECT, FRAME_LEN) stacked forward models."""
    return np.stack(
        [forward_matrix_direct(lo, hi, fs) for lo, hi in BAND_PLAN])


def all_demod_matrices(fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Stacked matrices: (4, P, 1215, W_direct), (4, 1, 1215, W_cascade)."""
    md = np.stack([
        np.stack([demod_matrix_direct(lo, hi, fs, lam)
                  for lam in LAM_DIRECT_PROFILES])
        for lo, hi in BAND_PLAN
    ])
    mc = np.stack([
        demod_matrix_cascade(lo, hi, fs)[None] for lo, hi in BAND_PLAN
    ])
    return md, mc


@lru_cache(maxsize=8)
def sync_templates(fs: int) -> np.ndarray:
    """(4, PRE_L) float32 unit-norm singly-filtered MLS templates.

    The stream is correlated raw (no RX refilter) against the TX-filtered
    preamble; correlation itself does the band selection.
    """
    pre = bits_to_bpsk(mls63(), dtype=np.float64)
    out = []
    for lo, hi in BAND_PLAN:
        b, a = filters.butter_coeffs(lo, hi, fs)
        t = lfilter(b, a, pre)
        out.append((t / (np.linalg.norm(t) + 1e-12)).astype(np.float32))
    return np.stack(out)


# ======================================================================
# device-side pipeline pieces (pure, jittable)
# ======================================================================
def slice_windows(x: jnp.ndarray, starts: jnp.ndarray,
                  span: int) -> jnp.ndarray:
    """Contiguous windows ``x[..., s : s + span]`` for a start lattice.

    ``x``: (T,) or (B, T); ``starts``: int32 with a leading B axis when
    ``x`` is 2-D.  Returns ``starts.shape + (span,)``.  Starts are
    clamped to ``[0, T - span]`` explicitly -- ``dynamic_slice`` alone
    clamps the upper bound but wraps NEGATIVE starts through the
    unsigned range on this backend (observed: -9 landed at T - span).

    A vmapped ``dynamic_slice`` lowers to ONE gather HLO whose slice
    size is the whole window, instead of a ``take_along_axis`` over a
    per-sample index lattice (a gather of individual ELEMENTS, 9720 per
    v2 window); the output is bit-identical.
    """
    starts = jnp.clip(starts.astype(jnp.int32), 0, x.shape[-1] - span)
    if x.ndim == 1:
        flat = starts.reshape(-1)
        win = jax.vmap(
            lambda s: jax.lax.dynamic_slice(x, (s,), (span,)))(flat)
        return win.reshape(*starts.shape, span)

    def per_row(xi, si):
        return jax.vmap(
            lambda s: jax.lax.dynamic_slice(xi, (s,), (span,)))(si)

    flat = starts.reshape(x.shape[0], -1)
    win = jax.vmap(per_row)(x, flat)
    return win.reshape(*starts.shape, span)


def normalized_xcorr(x: jnp.ndarray, templates: jnp.ndarray,
                     compute_dtype=None) -> jnp.ndarray:
    """Sliding cosine similarity of ``x`` (..., T) vs (B, L) templates.

    Returns (..., B, T - L + 1).  Both the template correlation and the
    sliding-window energy are short-kernel convolutions (XLA hands them
    to the convolution library), not an FFT formulation, whose
    power-of-two round-up doubles an already padded clip and streams
    GB-scale complex intermediates through device memory.  Mirrors
    detector.py:75-79 without the RX IIR.

    ``compute_dtype=jnp.bfloat16`` runs the convs on bf16 tensor cores
    with f32 accumulation.  Sync is pure peak-FINDING -- scores only
    gate/rank candidate positions, they never enter the chip estimates
    -- so the ~0.4% relative error is harmless there.  Keep f32 anywhere
    the output feeds demodulation; with ``compute_dtype=None`` the convs
    are pinned to full f32 precision (no TF32).
    """
    L = templates.shape[-1]
    nb = templates.shape[0]
    lead = x.shape[:-1]
    xr = x.reshape((-1, 1) + x.shape[-1:])          # (N, C=1, T)
    kern = templates[:, None, :]                     # (O=nb, I=1, L)
    x2 = xr * xr                                     # square in f32 always
    if compute_dtype is not None:
        xr = xr.astype(compute_dtype)
        kern = kern.astype(compute_dtype)
        x2 = x2.astype(compute_dtype)
    prec = (jax.lax.Precision.HIGHEST if compute_dtype is None
            else jax.lax.Precision.DEFAULT)
    dn = jax.lax.conv_dimension_numbers(xr.shape, kern.shape,
                                        ("NCW", "OIW", "NCW"))
    corr = jax.lax.conv_general_dilated(
        xr, kern, window_strides=(1,), padding="VALID",
        dimension_numbers=dn, precision=prec,
        preferred_element_type=jnp.float32)

    ones = jnp.ones((1, 1, L), xr.dtype)
    e2 = jax.lax.conv_general_dilated(
        x2, ones, window_strides=(1,), padding="VALID",
        dimension_numbers=dn, precision=prec,
        preferred_element_type=jnp.float32)
    energy = jnp.sqrt(jnp.maximum(e2, 0.0)) + 1e-12
    return (corr / energy).reshape(lead + (nb, corr.shape[-1]))


def cfar_threshold(corr: jnp.ndarray) -> jnp.ndarray:
    """median + 4.5 * 1.4826 * MAD, capped at 0.95 (detector.py:83-87)."""
    med = jnp.median(corr, axis=-1, keepdims=True)
    mad = jnp.median(jnp.abs(corr - med), axis=-1, keepdims=True) + 1e-12
    return jnp.minimum(med + 4.5 * 1.4826 * mad, 0.95)[..., 0]


def topk_nms(corr: jnp.ndarray, k: int, min_dist: int):
    """Greedy non-max suppression: k exact local maxima, descending value.

    Returns (idx (..., k) int32, val (..., k) float32).  Each iteration
    takes the global argmax then masks +-min_dist around it -- identical to
    the reference's NMS-over-threshold followed by ordering (detector.py:
    89-99) for the peaks that matter.
    """
    T = corr.shape[-1]
    pos = jnp.arange(T, dtype=jnp.int32)

    def body(carry, _):
        c = carry
        i = jnp.argmax(c, axis=-1)
        v = jnp.take_along_axis(c, i[..., None], axis=-1)[..., 0]
        mask = jnp.abs(pos - i[..., None]) <= min_dist
        return jnp.where(mask, -jnp.inf, c), (i.astype(jnp.int32), v)

    _, (idx, val) = jax.lax.scan(body, corr, None, length=k)
    # scan stacks on axis 0 -> move peak axis last
    idx = jnp.moveaxis(idx, 0, -1)
    val = jnp.moveaxis(val, 0, -1)
    return idx, val


def gather_windows(x: jnp.ndarray, starts: jnp.ndarray, width: int) -> jnp.ndarray:
    """Gather (N,) start indices -> (N, width) windows from 1-D ``x``.

    Starts are clipped to keep windows in range (callers pad the signal so
    clipping only affects degenerate peaks near the edges).
    """
    starts = jnp.clip(starts, 0, x.shape[-1] - width).astype(jnp.int32)
    offs = jnp.arange(width, dtype=jnp.int32)
    return x[starts[:, None] + offs[None, :]]


def demod_chips(windows: jnp.ndarray, M: jnp.ndarray) -> jnp.ndarray:
    """(N, W) windows x (FRAME_LEN, W) demod matrix -> (N, FRAME_LEN) chips."""
    return jax.lax.dot_general(
        windows, M,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def refine_chips(windows: jnp.ndarray, chips: jnp.ndarray,
                 T_fwd: jnp.ndarray, M: jnp.ndarray, pre_sy: jnp.ndarray,
                 iters: int = 8) -> jnp.ndarray:
    """Hard-projection iterative refinement of LS chip estimates.

    Exploits the +-1 alphabet and the known 63-chip preamble: project the
    current estimate to the nearest BPSK sequence (preamble pinned to its
    true symbols), re-synthesise through the forward model, and correct
    with the residual.  Measured: single-frame chip BER 1.5% -> 0.2%
    (band 8-10 kHz, f32), which brings digitally-clean captures within the
    reference-compatible FEC's tolerance.  2 matmuls/iteration.

    Shapes: windows (..., W), chips (..., FRAME_LEN),
            T_fwd (..., W, FRAME_LEN), M (..., FRAME_LEN, W).
    """
    z = chips
    for _ in range(iters):
        c_hard = jnp.sign(z)
        c_hard = c_hard.at[..., :PRE_L].set(pre_sy)
        amp = jnp.mean(z * c_hard, axis=-1, keepdims=True)
        ch = c_hard * amp
        synth = jnp.einsum("...wk,...k->...w", T_fwd, ch,
                           precision=jax.lax.Precision.HIGHEST)
        resid = windows - synth
        z = ch + jnp.einsum("...kw,...w->...k", M, resid,
                            precision=jax.lax.Precision.HIGHEST)

    # ---- greedy bit-flip descent on the exact integer-LS objective ------
    # Flipping chip j changes ||y - amp T c||^2 by
    #   delta_j = 4 amp c_j (T^T r)_j + 4 amp^2 ||t_j||^2 ;
    # repeatedly flip the best j while it improves.  On clean captures this
    # walks the last 1-3 residual chip errors to the exact ML sequence,
    # which the hard-decision CRC pass then accepts without any SCL.
    c = jnp.sign(z)
    c = c.at[..., :PRE_L].set(pre_sy)
    amp = jnp.mean(z * c, axis=-1, keepdims=True)
    col_n2 = jnp.sum(T_fwd * T_fwd, axis=-2)               # (..., FRAME_LEN)
    synth = jnp.einsum("...wk,...k->...w", T_fwd, c * amp,
                       precision=jax.lax.Precision.HIGHEST)
    r = windows - synth

    def flip_step(carry, _):
        c, r = carry
        s = jnp.einsum("...wk,...w->...k", T_fwd, r,
                       precision=jax.lax.Precision.HIGHEST)
        delta = 4.0 * amp * c * s + 4.0 * amp * amp * col_n2
        delta = delta.at[..., :PRE_L].set(jnp.inf)          # preamble pinned
        j = jnp.argmin(delta, axis=-1)
        dmin = jnp.take_along_axis(delta, j[..., None], axis=-1)
        do = (dmin < 0.0).astype(c.dtype)                   # (..., 1)
        onehot = jax.nn.one_hot(j, c.shape[-1], dtype=c.dtype)
        cj = jnp.take_along_axis(c, j[..., None], axis=-1)
        c_new = c - 2.0 * do * onehot * cj
        # r += 2 amp c_j_old t_j  (flip removes 2*amp*c_old*t_j from synth)
        tj = jnp.einsum("...wk,...k->...w", T_fwd, onehot,
                        precision=jax.lax.Precision.HIGHEST)
        r_new = r + 2.0 * amp * do * cj * tj
        return (c_new, r_new), None

    (c, r), _ = jax.lax.scan(flip_step, (c, r), None, length=12)
    # final soft output: anchored hard decisions + LS residual correction
    ch = c * amp
    synth = jnp.einsum("...wk,...k->...w", T_fwd, ch,
                       precision=jax.lax.Precision.HIGHEST)
    z = ch + jnp.einsum("...kw,...w->...k", M, windows - synth,
                        precision=jax.lax.Precision.HIGHEST)
    return z


def preamble_score(chips: jnp.ndarray, pre_sy: jnp.ndarray) -> jnp.ndarray:
    """Cosine of the first 63 recovered chips vs the raw MLS symbols."""
    seg = chips[..., :PRE_L]
    num = jnp.einsum("...i,i->...", seg, pre_sy,
                     precision=jax.lax.Precision.HIGHEST)
    den = jnp.linalg.norm(seg, axis=-1) * np.sqrt(float(PRE_L)) + 1e-12
    return num / den


def header_decode(chips: jnp.ndarray, hdr_pn_sy: jnp.ndarray):
    """Majority-decode the 16-bit counter header from recovered chips.

    Mirrors detector.py:452-515's group-majority logic in the chip domain
    (alignment comes from the demod window, so no shift search is needed).
    Returns (ok (...,) bool, lo16 (...,) int32, score (...,) float32).
    """
    seg = chips[..., PRE_L : PRE_L + HDR_L]
    d = seg * hdr_pn_sy
    sums = d.reshape(d.shape[:-1] + (HDR_BITS, HDR_REPEAT)).sum(axis=-1)
    bits = (sums > 0.0).astype(jnp.int32)
    weights = (2 ** jnp.arange(HDR_BITS - 1, -1, -1, dtype=jnp.int32))
    lo16 = jnp.sum(bits * weights, axis=-1)
    rms = jnp.sqrt(jnp.mean(d * d, axis=-1)) + 1e-12
    margin = jnp.mean(jnp.abs(sums), axis=-1) / (rms * HDR_REPEAT)
    score = jnp.mean(jnp.abs(sums), axis=-1) / (jnp.std(d, axis=-1) + 1e-12)
    ok = margin > 0.5
    return ok, lo16, score


def payload_llr(chips: jnp.ndarray, pn_sy: jnp.ndarray,
                clip: float = 16.0) -> jnp.ndarray:
    """Despread recovered chips and normalise into decoder LLRs.

    Positive LLR favours bit 1 (polar_fast.py:67 convention).

    No mean subtraction: polar codewords over a mostly-frozen ``u`` are NOT
    balanced in {0,1} (many code positions are deterministically 0), so the
    despread mean carries *signal*, not bias -- centering it (as the
    reference does, detector.py:396-397) shifts every chip by a fraction of
    the signal amplitude.  The LS demod noise is zero-mean by construction.

    Scaling is the Gaussian-mixture moment estimate: with z ~ +-a + n,
    E[z^2] = a^2 + s^2 and E|z| ~= a for a >> s, so
    llr = 2 a z / s^2 after unit-power normalisation.

    The chain is elementwise work plus two row reductions, which XLA
    fuses into one or two reduction kernels.
    """
    z = chips[..., PRE_L + HDR_L :] * pn_sy
    power = jnp.mean(z * z, axis=-1, keepdims=True) + 1e-20
    zn = z * jax.lax.rsqrt(power)
    amp = jnp.clip(jnp.mean(jnp.abs(zn), axis=-1, keepdims=True), 0.05, 1.0)
    sigma2 = jnp.maximum(1.0 - amp * amp, 0.05)
    return jnp.clip(2.0 * amp * zn / sigma2, -clip, clip)
