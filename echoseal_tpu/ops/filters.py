"""Band-pass filtering: host-side Butterworth design, device-side execution.

Design (coefficients, impulse responses, matched-filter taps, correlation
templates) happens once on the host in float64 via SciPy and is cached as
small constants.  Execution on long signals happens on the device:

* ``iir_apply``  -- exact ``scipy.signal.lfilter`` semantics (direct-form II
  transposed) as a ``lax.scan`` over time, batched over leading axes.  Used
  where waveform parity with the reference matters (TX frame synthesis,
  RX band scan).
* ``fir_apply``  -- FFT/overlap convolution with a truncated impulse
  response.  Much faster for very long signals; an approximation of the IIR
  good to ~1e-6 relative, used in the high-throughput batch pipeline.

Reference behaviour reproduced here: order-4 Butterworth band-pass
(utils.py:52-55); frames filtered from zero initial state with the IIR state
carried from preamble into header+payload (embedder.py:137-144) -- which is
exactly one zero-state pass over the concatenated frame; the detector's
matched filter is the time-reversed, 99.9%-energy-truncated TX*RX cascade
impulse response (detector.py:260-294); its preamble template is the
doubly-filtered MLS (detector.py:63-69).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from scipy.signal import butter, lfilter, sosfilt

from echoseal_tpu.core.bandplan import BAND_PLAN
from echoseal_tpu.core.sequences import bits_to_bpsk, mls63

IIR_ORDER = 4  # -> 8th-order transfer function for a band-pass


# ----------------------------------------------------------- host-side design
@lru_cache(maxsize=64)
def butter_coeffs(lo: float, hi: float, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """(b, a) float64 transfer-function coefficients, a[0] == 1."""
    nyq = 0.5 * fs
    b, a = butter(IIR_ORDER, [lo / nyq, hi / nyq], "band")
    return np.asarray(b), np.asarray(a)


@lru_cache(maxsize=64)
def butter_sos(lo: float, hi: float, fs: int) -> np.ndarray:
    """(4, 6) float64 second-order sections of the same band-pass.

    Numerically equivalent to ``butter_coeffs`` but far better conditioned in
    float32 -- the device IIR path uses this cascade form so a single-pass
    f32 scan tracks the reference's float64 direct form to ~1e-6.
    """
    nyq = 0.5 * fs
    return butter(IIR_ORDER, [lo / nyq, hi / nyq], "band", output="sos")


def all_band_sos(fs: int) -> np.ndarray:
    """Stacked (4, 4, 6) float32 SOS for the whole band plan."""
    return np.stack(
        [butter_sos(lo, hi, fs).astype(np.float32) for lo, hi in BAND_PLAN]
    )


@lru_cache(maxsize=64)
def impulse_response(lo: float, hi: float, fs: int, length: int = 256) -> np.ndarray:
    """float64 impulse response of the band filter, ``length`` samples."""
    b, a = butter_coeffs(lo, hi, fs)
    imp = np.zeros(length)
    imp[0] = 1.0
    return lfilter(b, a, imp)


@lru_cache(maxsize=64)
def matched_filter_taps(lo: float, hi: float, fs: int) -> np.ndarray:
    """Matched filter for the TX*RX filter cascade (float32).

    impulse(256) -> TX filter -> self-convolve (RX applies the same band-pass
    again) -> truncate at 99.9% cumulative energy -> time-reverse ->
    unit-energy normalise.  Mirrors detector.py:260-294 so alignment search
    windows land on the same taps.
    """
    g_tx = impulse_response(lo, hi, fs).astype(np.float32)
    g_eff = np.convolve(g_tx, g_tx).astype(np.float32)
    energy = np.cumsum(g_eff * g_eff)
    total = float(energy[-1]) + 1e-20
    idx = int(np.searchsorted(energy, 0.999 * total))
    if idx + 1 < g_eff.size:
        g_eff = g_eff[: idx + 1]
    h = g_eff[::-1].copy()
    h /= np.sqrt(float(np.sum(h * h))) + 1e-12
    return h


@lru_cache(maxsize=64)
def preamble_template(lo: float, hi: float, fs: int) -> np.ndarray:
    """Unit-norm doubly-filtered MLS-63 preamble template (float32)."""
    b, a = butter_coeffs(lo, hi, fs)
    pre_sy = bits_to_bpsk(mls63(), dtype=np.float64)
    tpl = lfilter(b, a, lfilter(b, a, pre_sy))
    tpl = tpl / (np.sqrt(np.sum(tpl * tpl)) + 1e-12)
    return tpl.astype(np.float32)


def all_band_coeffs(fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Stacked (4, 9) float32 b and a coefficients for the whole band plan."""
    bs, ars = [], []
    for lo, hi in BAND_PLAN:
        b, a = butter_coeffs(lo, hi, fs)
        bs.append(b.astype(np.float32))
        ars.append(a.astype(np.float32))
    return np.stack(bs), np.stack(ars)


# ---------------------------------------------------------- device execution
def iir_apply(b, a, x, zi=None):
    """``lfilter(b, a, x, zi)`` on device: DF2T scan over the last axis.

    ``x`` may have arbitrary leading batch axes; ``b``/``a`` may either be
    1-D (shared) or carry matching leading axes (per-batch filters, e.g. the
    4-band filterbank).  Returns (y, zf) with ``zf`` the final state, so
    callers can chain segments exactly like SciPy's ``zi``/``zf``.
    """
    b = jnp.asarray(b, dtype=x.dtype)
    a = jnp.asarray(a, dtype=x.dtype)
    order = b.shape[-1] - 1
    batch_shape = x.shape[:-1]
    if zi is None:
        z0 = jnp.zeros(batch_shape + (order,), dtype=x.dtype)
    else:
        z0 = jnp.broadcast_to(jnp.asarray(zi, dtype=x.dtype),
                              batch_shape + (order,))

    b0 = b[..., 0]
    b_rest = b[..., 1:]  # (..., order), broadcasts against batch axes
    a_rest = a[..., 1:]

    xs = jnp.moveaxis(x, -1, 0)  # (T, ...batch)

    def step(z, xt):
        y = b0 * xt + z[..., 0]
        # z_j' = b_{j+1} x + z_{j+1} - a_{j+1} y   (z_order == 0 implicitly)
        z_shift = jnp.concatenate(
            [z[..., 1:], jnp.zeros_like(z[..., :1])], axis=-1
        )
        return z_shift + b_rest * xt[..., None] - a_rest * y[..., None], y

    zf, ys = jax.lax.scan(step, z0, xs)
    return jnp.moveaxis(ys, 0, -1), zf


def sos_apply(sos, x, zi=None):
    """Cascaded-biquad IIR on device (scipy ``sosfilt`` semantics).

    ``sos``: (..., S, 6) sections, broadcastable against ``x``'s batch axes.
    ``x``:   (..., T).  Returns (y, zf) with zf shaped (..., S, 2).
    One ``lax.scan`` over time executes all S sections per step; the batch
    rides the vector lanes.
    """
    sos = jnp.asarray(sos, dtype=x.dtype)
    n_sections = sos.shape[-2]
    batch_shape = x.shape[:-1]
    if zi is None:
        z0 = jnp.zeros(batch_shape + (n_sections, 2), dtype=x.dtype)
    else:
        z0 = jnp.broadcast_to(
            jnp.asarray(zi, dtype=x.dtype), batch_shape + (n_sections, 2)
        )

    b0, b1, b2 = sos[..., 0], sos[..., 1], sos[..., 2]
    a1, a2 = sos[..., 4], sos[..., 5]

    xs = jnp.moveaxis(x, -1, 0)  # (T, ...batch)

    def step(z, xt):
        # unrolled cascade (S is tiny and static)
        v = xt
        z_new = []
        for s in range(n_sections):
            zs0 = z[..., s, 0]
            zs1 = z[..., s, 1]
            y = b0[..., s] * v + zs0
            z_new0 = b1[..., s] * v - a1[..., s] * y + zs1
            z_new1 = b2[..., s] * v - a2[..., s] * y
            z_new.append(jnp.stack([z_new0, z_new1], axis=-1))
            v = y
        return jnp.stack(z_new, axis=-2), v

    zf, ys = jax.lax.scan(step, z0, xs)
    return jnp.moveaxis(ys, 0, -1), zf


@lru_cache(maxsize=64)
def fir_from_iir(lo: float, hi: float, fs: int, tol: float = 1e-7) -> np.ndarray:
    """Truncated impulse response approximating the IIR to ``tol`` (float32).

    Tail is cut where the remaining energy fraction drops below ``tol**2``.
    """
    h = impulse_response(lo, hi, fs, length=8192)
    tail = np.sqrt(np.cumsum((h * h)[::-1])[::-1] / (np.sum(h * h) + 1e-30))
    keep = int(np.argmax(tail < tol)) or h.size
    return h[: max(keep, 64)].astype(np.float32)


def fft_convolve_full(x, h):
    """'full' linear convolution along the last axis via rFFT (device)."""
    T = x.shape[-1]
    L = h.shape[-1]
    n = T + L - 1
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    X = jnp.fft.rfft(x, nfft)
    H = jnp.fft.rfft(h, nfft)
    y = jnp.fft.irfft(X * H, nfft)[..., :n]
    return y.astype(x.dtype)


def fir_apply(h, x):
    """Causal FIR filtering (same output length as ``x``) along last axis."""
    return fft_convolve_full(x, h)[..., : x.shape[-1]]
