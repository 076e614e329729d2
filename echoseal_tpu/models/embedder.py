"""Watermark transmitter (TX engine).

Two execution tiers behind one API:

* **Streaming path** (`WatermarkEmbedder.process`): sample-accurate NumPy
  mixer for the real-time audio callback.  A device round-trip per 21 ms
  audio block would add latency for no gain (SURVEY.md sec 7.4.5), so frame
  chips are synthesised host-side exactly like the reference
  (rtwm/embedder.py:44-151): per-frame seal -> polar encode -> BPSK ->
  counter header -> PN spread -> stateful Butterworth band-pass -> peak
  guard, mixed at an RMS-proportional level with an absolute floor and a
  clip-headroom limiter.
* **Batch path** (`synthesize_frames` / `embed_batch`): whole-file or
  multi-stream TX as a single device program -- frames batched on a leading
  axis, polar encoding as one butterfly matmul pass, the band-pass as a
  vmapped IIR scan with per-frame coefficients.  This is the path the
  throughput benchmarks use.

Frame format parity is pinned by tests/golden/reference_vectors.npz
(frames generated by rtwm/embedder.py:78-151 for ctr in {0, 5, 1000}).
"""
from __future__ import annotations

import functools
import secrets

import numpy as np
from scipy.signal import lfilter

import jax
import jax.numpy as jnp

from echoseal_tpu.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_tpu.core.crypto import SecureChannel
from echoseal_tpu.core.params import (
    EPS,
    FRAME_LEN,
    FRAME_PEAK_GUARD,
    HDR_L,
    MIX_HEADROOM,
    PRE_L,
    TxParams,
)
from echoseal_tpu.core.sequences import bits_to_bpsk, header_bits
from echoseal_tpu.ops import filters
from echoseal_tpu.ops.polar import encode_batch, encode_np, polar_spec


def db_to_lin(db: float) -> float:
    return 10.0 ** (db / 20.0)


class WatermarkEmbedder:
    """Streaming watermark mixer (reference WatermarkEmbedder surface)."""

    def __init__(self, key32: bytes, params: TxParams | None = None) -> None:
        self.p = params or TxParams()
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self.frame_ctr = 0
        self._chip_buf = np.empty(0, dtype=np.float32)
        self._session_nonce = secrets.token_bytes(8)
        self._spec = polar_spec(self.p.N, self.p.K)
        self._preamble_sy = bits_to_bpsk(self.p.preamble)
        # header PN is counter-independent: always the frame-0 stream
        self._hdr_pn_sy = bits_to_bpsk(self.sec.pn_bits(0, HDR_L))

    # ------------------------------------------------------------------ API
    def process(self, samples: np.ndarray) -> np.ndarray:
        """Mix watermark chips into ``samples`` (reference embedder.py:44-75).

        Level = max(host_rms * 10^(target_rel_db/20), floor) capped so the
        mix never exceeds MIX_HEADROOM peak.
        """
        x = np.asarray(samples).astype(np.float32, copy=False)
        in_rms = float(np.sqrt(np.mean(x * x)) + EPS) if x.size else EPS

        needed = x.size
        while self._chip_buf.size < needed:
            self._chip_buf = np.concatenate(
                (self._chip_buf, self._make_frame_chips())
            )
            self.frame_ctr = (self.frame_ctr + 1) % (2**32)

        chips = self._chip_buf[:needed]
        self._chip_buf = self._chip_buf[needed:]

        scale = max(
            db_to_lin(self.p.target_rel_db) * in_rms,
            db_to_lin(self.p.floor_rel_dbfs),
        )
        headroom = max(MIX_HEADROOM - float(np.max(np.abs(x), initial=0.0)), 0.0)
        peak = float(np.max(np.abs(chips), initial=0.0)) + EPS
        scale = min(scale, headroom / peak) if peak > 0.0 else 0.0
        return x + chips * scale

    # ------------------------------------------------------------ internals
    def _build_payload(self) -> bytes:
        """Seal the 27-byte plaintext -> 55-byte blob (embedder.py:153-168)."""
        meta = (
            b"ESAL"
            + self.frame_ctr.to_bytes(4, "big")
            + self._session_nonce
            + secrets.token_bytes(11)
        )
        blob = self.sec.seal(meta)
        assert len(blob) == 55
        return blob

    def _make_frame_chips(self) -> np.ndarray:
        """One 1215-chip watermark frame for the current counter."""
        return synthesize_frame_np(
            self.sec,
            self._hop,
            self.frame_ctr,
            self._build_payload(),
            fs=self.p.fs,
            preamble_sy=self._preamble_sy,
            hdr_pn_sy=self._hdr_pn_sy,
            spec=self._spec,
        )


# ----------------------------------------------------------- host synthesis
def synthesize_frame_np(
    sec: SecureChannel,
    hop,
    frame_ctr: int,
    payload: bytes,
    *,
    fs: int = 48_000,
    preamble_sy: np.ndarray | None = None,
    hdr_pn_sy: np.ndarray | None = None,
    spec=None,
) -> np.ndarray:
    """Reference-exact single-frame synthesis (embedder.py:78-151).

    scipy ``lfilter`` runs in float64 (matching the reference's dtype
    promotion) and the result is cast to float32 at the end.
    """
    spec = spec or polar_spec()
    if preamble_sy is None:
        preamble_sy = bits_to_bpsk(TxParams().preamble)
    if hdr_pn_sy is None:
        hdr_pn_sy = bits_to_bpsk(sec.pn_bits(0, HDR_L))

    band = hop.band(frame_ctr)
    data_bits = encode_np(payload, spec)
    data_sy = bits_to_bpsk(data_bits)

    hdr_sy = bits_to_bpsk(header_bits(frame_ctr)) * hdr_pn_sy

    pn_full = sec.pn_bits(frame_ctr, FRAME_LEN)
    pn_sy = bits_to_bpsk(pn_full[PRE_L + HDR_L :])
    spread = data_sy * pn_sy

    b, a = filters.butter_coeffs(band[0], band[1], fs)
    zi0 = np.zeros(max(len(a), len(b)) - 1, dtype=np.float64)
    y_pre, zi1 = lfilter(b, a, preamble_sy, zi=zi0)
    y_rest, _ = lfilter(b, a, np.concatenate((hdr_sy, spread)), zi=zi1)
    chips = np.concatenate((y_pre, y_rest))

    peak = float(np.max(np.abs(chips))) + EPS
    if peak > FRAME_PEAK_GUARD:
        chips = chips / peak
    return chips.astype(np.float32)


# ---------------------------------------------------------- device synthesis
@functools.partial(jax.jit, static_argnames=("spec",))
def synthesize_frames_device(
    info_bits: jnp.ndarray,
    hdr_bits: jnp.ndarray,
    pn_payload_bits: jnp.ndarray,
    hdr_pn_sy: jnp.ndarray,
    preamble_sy: jnp.ndarray,
    band_sos: jnp.ndarray,
    spec=None,
) -> jnp.ndarray:
    """Batched TX on device: (B, ...) inputs -> (B, FRAME_LEN) float32 chips.

    Args:
      info_bits:       (B, 440) {0,1} payload info bits (pre-CRC).
      hdr_bits:        (B, 128) expanded header bits.
      pn_payload_bits: (B, 1024) per-frame payload PN bits.
      hdr_pn_sy:       (128,) +-1 header PN symbols (frame-0 stream).
      preamble_sy:     (63,) +-1 preamble symbols.
      band_sos:        (B, 4, 6) per-frame Butterworth biquad sections.

    The polar encode is a GF(2) butterfly over the whole batch; the IIR
    band-pass is a single ``lax.scan`` over the 1215 chips with the batch on
    vector lanes.  Crypto (seal, PN, HMAC hop) happens host-side before this
    call, so the function is pure and jittable.
    """
    spec = spec or polar_spec()
    B = info_bits.shape[0]
    data_bits = encode_batch(info_bits, spec)  # (B, 1024)
    data_sy = 2.0 * data_bits.astype(jnp.float32) - 1.0
    pn_sy = 2.0 * pn_payload_bits.astype(jnp.float32) - 1.0
    hdr_sy = (2.0 * hdr_bits.astype(jnp.float32) - 1.0) * hdr_pn_sy[None, :]
    pre = jnp.broadcast_to(preamble_sy[None, :], (B, PRE_L))
    symbols = jnp.concatenate([pre, hdr_sy, data_sy * pn_sy], axis=-1)

    chips, _ = filters.sos_apply(band_sos, symbols)
    peak = jnp.max(jnp.abs(chips), axis=-1, keepdims=True) + EPS
    return jnp.where(peak > FRAME_PEAK_GUARD, chips / peak, chips).astype(
        jnp.float32
    )


class BatchEmbedder:
    """Bulk TX: watermark whole buffers / many streams in one device pass.

    Handles the host-side crypto fan-out (seals, PN streams, hop schedule)
    and dispatches one jitted program for all frames of all streams.
    """

    def __init__(self, key32: bytes, params: TxParams | None = None) -> None:
        self.p = params or TxParams()
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self._spec = polar_spec(self.p.N, self.p.K)
        self._preamble_sy = bits_to_bpsk(self.p.preamble)
        self._hdr_pn_sy = bits_to_bpsk(self.sec.pn_bits(0, HDR_L))
        self._band_sos = filters.all_band_sos(self.p.fs)

    def chip_stream(
        self,
        n_samples: int,
        start_ctr: int = 0,
        session_nonce: bytes | None = None,
    ) -> np.ndarray:
        """Watermark chips covering ``n_samples``, frames start_ctr upward."""
        n_frames = -(-n_samples // FRAME_LEN)
        ctrs = np.arange(start_ctr, start_ctr + n_frames, dtype=np.int64)
        chips = self.frames(ctrs, session_nonce=session_nonce).reshape(-1)
        return chips[:n_samples]

    def frames(
        self, ctrs: np.ndarray, session_nonce: bytes | None = None
    ) -> np.ndarray:
        """(len(ctrs), FRAME_LEN) float32 frames, one device dispatch."""
        return np.asarray(self.frames_device(ctrs, session_nonce))

    def frames_device(
        self, ctrs: np.ndarray, session_nonce: bytes | None = None
    ) -> jnp.ndarray:
        """Like ``frames`` but returns the device array WITHOUT downloading.

        Callers composing further device work (benchmark clip staging,
        whole-stream synthesis) keep the ~580 KB/dispatch result on the
        device instead of downloading it.
        """
        ctrs = np.asarray(ctrs, dtype=np.int64)
        nonce = session_nonce or secrets.token_bytes(8)
        payloads = [
            self.sec.seal(
                b"ESAL"
                + int(c).to_bytes(4, "big")
                + nonce
                + secrets.token_bytes(11)
            )
            for c in ctrs
        ]
        info = np.stack(
            [np.unpackbits(np.frombuffer(p, dtype=np.uint8)) for p in payloads]
        )
        from echoseal_tpu.core.sequences import header_bits_batch

        hdr = header_bits_batch(ctrs)
        pn = self.sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L :]
        band_idx = self._hop.indices(ctrs)
        return synthesize_frames_device(
            jnp.asarray(info),
            jnp.asarray(hdr),
            jnp.asarray(pn),
            jnp.asarray(self._hdr_pn_sy),
            jnp.asarray(self._preamble_sy),
            jnp.asarray(self._band_sos[band_idx]),
            self._spec,
        )

    def embed(
        self,
        host: np.ndarray,
        start_ctr: int = 0,
        session_nonce: bytes | None = None,
    ) -> np.ndarray:
        """Watermark a whole host buffer with the reference mix law applied
        per FRAME_LEN-sized block (matches streaming `process` called with
        block == FRAME_LEN)."""
        x = np.asarray(host, dtype=np.float32)
        chips = self.chip_stream(x.size, start_ctr, session_nonce)
        out = np.empty_like(x)
        alpha = db_to_lin(self.p.target_rel_db)
        floor = db_to_lin(self.p.floor_rel_dbfs)
        for i in range(0, x.size, FRAME_LEN):
            xs = x[i : i + FRAME_LEN]
            cs = chips[i : i + FRAME_LEN]
            rms = float(np.sqrt(np.mean(xs * xs)) + EPS)
            scale = max(alpha * rms, floor)
            headroom = max(MIX_HEADROOM - float(np.max(np.abs(xs))), 0.0)
            peak = float(np.max(np.abs(cs))) + EPS
            scale = min(scale, headroom / peak)
            out[i : i + FRAME_LEN] = xs + cs * scale
        return out
