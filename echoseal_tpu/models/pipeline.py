"""Batched multi-stream verification -- the serving/throughput pipeline.

Where ``WatermarkDetector.verify`` preserves the reference's full fallback
ladder for one clip, this pipeline verifies THOUSANDS of clips per device
dispatch (the BASELINE.json north star: >=1000x real-time per chip):

* All per-key randomness is precomputed once into device tables: the PN
  payload keystream for every frame counter below ``max_ctr`` (one AES
  pass on the host) and the HMAC hop schedule.  The device program is then
  completely crypto-free and static-shaped.
* Per clip: 4-band sync correlation -> top-``peaks`` NMS peaks -> direct
  LS demod + refinement at ``n_offsets`` alignments -> header decode ->
  counter resolution against the hop table (header-gated, time-estimated)
  -> PN gather -> LLR -> hard-decision polar + CRC.
* The host finishes with the AEAD open + magic/ctr checks per clip
  (microseconds each) -- crypto stays host-side by design (SURVEY.md 7.1).

Scale-out: `shard_map` over a 1-D ``streams`` mesh axis -- clips are
independent, so the only collective is an optional verdict-count psum
(echoseal_tpu/parallel/mesh.py).

Tier parity (measured, benchmarks/tier_compare.json): the compat batch
tier is hard-decision-only with ``peaks=2`` while the single-clip detector
adds the cascade demod variant and a raw-chip SCL ladder -- but across
every clip class the compat format can carry at all (clean, non-aligned
mid-stream cuts, excerpts, 5 ms dropouts, counters past the PN table),
both tiers accept 8/8 with ZERO diverging verdicts.  The extra single-clip
machinery only matters in the gray zone the wire format itself cannot
traverse (ops/demod.py), so the serving tier deliberately omits it.
"""
from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np

from echoseal_tpu.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_tpu.core.crypto import SecureChannel
from echoseal_tpu.core.params import FRAME_LEN, HDR_L, MAGIC, PRE_L, WIDE_DELTA
from echoseal_tpu.core.sequences import bits_to_bpsk, mls63
from echoseal_tpu.ops import demod
from echoseal_tpu.ops.polar import (
    PolarSpec,
    hard_decode_batch,
    pack_info_bits,
    polar_spec,
)
from echoseal_tpu.utils.logging import Timer, get_logger

_LOG = get_logger("pipeline")

DEFAULT_MAX_CTR = 16_384     # ~7 min of stream @ 39.5 frames/s
DEFAULT_PEAKS = 2            # sync peaks examined per band per clip
N_OFFSETS = len(demod.SYNC_OFFSETS)

# SCL fallback list-size escalation: rungs below the configured
# list_size that still-failing clips climb through; each rung rescues
# most of its survivors at ~L/L_max of the fixed-L cost, and the final
# rung equals the configured list size, so the rescue set can only
# GROW vs the fixed-L fallback (rescue is a disjunction over rows and
# rungs; accepts are AEAD-gated so extra attempts cannot false-accept).
SCL_LADDER = (8, 32)


def resolve_sync_dtype(sync_dtype):
    """Resolve the sync-conv compute precision knob to a jnp dtype.

    Accepts the documented strings ``"bf16"``/``"f32"`` (or ``None`` for
    the bf16 tensor-core default), and passes jnp dtypes through unchanged so
    callers that already hold a resolved dtype (e.g. the sharded tier)
    compose.  Anything else raises -- mirroring
    ``robust.resolve_table_dtype``'s strict validation so a typo like
    ``"bfloat16"`` cannot silently select float32 (ADVICE r4).
    """
    if sync_dtype is None or sync_dtype == "bf16":
        return jnp.bfloat16
    if sync_dtype == "f32":
        return jnp.float32
    if sync_dtype in (jnp.bfloat16, jnp.float32):
        return sync_dtype
    raise ValueError(
        f"sync_dtype must be None, 'bf16' or 'f32', got {sync_dtype!r}")


class ClipDetail(typing.NamedTuple):
    """Per-clip accept detail (which session/frame authenticated, where).

    Filled into the optional ``details`` dict (clip index -> ClipDetail)
    by every accepting rung of the batch ladder, so monitoring
    deployments can tell WHICH session authenticated without re-running
    the single-clip tier (VERDICT r3 weak #7).
    """

    session_nonce: bytes
    frame_ctr: int
    stage: str                # 'hard' | 'scl' | 'ext_ctr'


@functools.partial(
    jax.jit, static_argnames=("peaks",))
def _batch_verify_stage(
    x: jnp.ndarray,           # (B, Tpad) float32 clips, zero padded
    n_valid: jnp.ndarray,     # (B,) int32 true lengths
    templates: jnp.ndarray,   # (4, 63)
    m_direct: jnp.ndarray,    # (4, 1215, W_DIRECT)  exact-inversion profile
    t_fwd: jnp.ndarray,       # (4, W_DIRECT, 1215)
    pre_sy: jnp.ndarray,      # (63,)
    hdr_pn_sy: jnp.ndarray,   # (128,)
    pn_table: jnp.ndarray,    # (MAX_CTR, 1024) int8 payload PN bits
    hop_table: jnp.ndarray,   # (MAX_CTR,) int32 band index per counter
    peaks: int = DEFAULT_PEAKS,
):
    B, T = x.shape

    # ---- sync & peaks ---------------------------------------------------
    corr = demod.normalized_xcorr(x, templates)            # (B, 4, T-62)
    lag = jnp.arange(corr.shape[-1])
    corr = jnp.where(lag[None, None, :] <= (n_valid[:, None, None]
                                            - FRAME_LEN), corr, -jnp.inf)
    idx, val = demod.topk_nms(corr, peaks, FRAME_LEN // 2)  # (B, 4, P)
    valid = jnp.isfinite(val)

    # ---- windows at offsets --------------------------------------------
    # ONE wide window per peak (slice-granular gather rows, not elements
    # -- see demod.slice_windows); the +-2 alignment offsets come from
    # static slices of it
    offs = np.asarray(demod.SYNC_OFFSETS)
    span = int(offs.max() - offs.min())
    wide_w = demod.W_DIRECT + span
    s0 = jnp.clip(idx + int(offs.min()), 0, T - wide_w)     # (B, 4, P)
    wide = demod.slice_windows(x, s0, wide_w)               # (B,4,P,wide)
    win = jnp.stack([wide[..., o : o + demod.W_DIRECT]
                     for o in range(span + 1)], axis=3)     # (B,4,P,O,W)
    win = win.reshape(B, 4, -1, demod.W_DIRECT)             # (B,4,P*O,W)
    win = win * jax.lax.rsqrt(jnp.mean(win * win, -1, keepdims=True) + 1e-30)

    # ---- demod + refine (exact-inversion profile) -----------------------
    chips = jnp.einsum("bfnw,fkw->bfnk", win, m_direct,
                       precision=jax.lax.Precision.HIGHEST)
    chips = demod.refine_chips(win, chips, t_fwd[None, :, None],
                               m_direct[None, :, None], pre_sy, iters=4)

    # ---- pick best offset per peak by preamble score ---------------------
    pre = demod.preamble_score(chips, pre_sy).reshape(B, 4, peaks, N_OFFSETS)
    best_o = jnp.argmax(jnp.abs(pre), axis=-1)              # (B, 4, P)
    flat = (jnp.arange(peaks)[None, None, :] * N_OFFSETS + best_o)
    chips = jnp.take_along_axis(
        chips.reshape(B, 4, peaks * N_OFFSETS, FRAME_LEN),
        flat[..., None], axis=2)                            # (B,4,P,1215)
    pre_best = jnp.take_along_axis(
        pre.reshape(B, 4, peaks * N_OFFSETS), flat, axis=-1)

    # ---- header + counter resolution -------------------------------------
    hdr_ok, lo16, hdr_score = demod.header_decode(chips, hdr_pn_sy)
    ctr_est = jnp.round(idx.astype(jnp.float32) / FRAME_LEN).astype(jnp.int32)
    max_ctr = pn_table.shape[0]
    band_ids = jnp.arange(4, dtype=jnp.int32)[None, :, None]

    # The 16-bit header identifies the counter ABSOLUTELY below 2**16, so a
    # readable header resolves ctr = lo16 for a clip cut from anywhere in
    # the stream -- unlike the reference's +-200-around-the-time-estimate
    # search (detector.py:122-142), which silently fails on clips recorded
    # later than ~5 s in.  Counters past the table are handled by the
    # host-side extended pass (lo16 + m*2**16, _extended_counter_pass).
    ctr, any_match = _resolve_counters(
        hdr_ok, lo16, ctr_est, hop_table, band_ids, max_ctr)

    # ---- PN gather, LLR, hard decode -------------------------------------
    pn_sy = 2.0 * pn_table[ctr].astype(jnp.float32) - 1.0   # (B,4,P,1024)
    llr = demod.payload_llr(chips, pn_sy)
    spec = polar_spec()
    info, crc_ok = hard_decode_batch(llr, spec)
    crc_ok = crc_ok & valid & any_match

    # select the first CRC-passing candidate per clip and pack its payload
    # to bytes ON DEVICE -- the host then downloads ~60 B/clip instead of
    # the full (4, P, 440) bit tensor (matters on thin host<->device links)
    flat_ok = crc_ok.reshape(B, -1)
    best = jnp.argmax(flat_ok, axis=-1)                     # first True
    sel_ok = jnp.take_along_axis(flat_ok, best[:, None], -1)[:, 0]
    sel_info = jnp.take_along_axis(
        info.reshape(B, -1, info.shape[-1]), best[:, None, None], 1)[:, 0]
    sel_ctr = jnp.take_along_axis(
        ctr.reshape(B, -1), best[:, None], -1)[:, 0]
    pow2 = (2 ** jnp.arange(7, -1, -1, dtype=jnp.int32))
    blob = jnp.sum(sel_info.reshape(B, -1, 8) * pow2, axis=-1).astype(
        jnp.uint8)                                          # (B, 55)
    host_packed = _pack_host_row(sel_ok, sel_ctr, blob)

    return dict(
        # host_packed is the host TRANSPORT (one download); ok/blob/
        # blob_ctr are its unpacked device-side views, kept for the
        # sharded dryrun's per-clip asserts (parallel/dryrun.py) and
        # debugging -- bytes-scale, never separately downloaded in
        # production paths
        ok=sel_ok, blob=blob, blob_ctr=sel_ctr,
        host_packed=host_packed,   # (B, 60) -- ONE host download
        crc_ok=crc_ok,             # (B, 4, P)
        info_bits=info,            # (B, 4, P, 440)
        ctr=ctr,                   # (B, 4, P)
        peak_idx=idx, peak_val=val,
        pre_score=pre_best, hdr_ok=hdr_ok, hdr_score=hdr_score,
        hdr_lo16=lo16,             # (B, 4, P) raw 16-bit header reads
        chips=chips,               # (B, 4, P, 1215) refined chip estimates
        # chips/hdr_lo16 feed the host-side extended-counter pass; device
        # outputs are lazy, so exporting them costs nothing until a failed
        # clip actually needs the escalation download.
    )


@functools.partial(jax.jit, static_argnames=("spec",))
def _llr_hard_stage(chips: jnp.ndarray, pn_sy: jnp.ndarray, spec: PolarSpec):
    """(N, 1215) chips + (N, 1024) PN symbols -> hard-decision decode."""
    llr = demod.payload_llr(chips, pn_sy)
    info, crc_ok = hard_decode_batch(llr, spec)
    return info, crc_ok


@functools.partial(jax.jit, static_argnames=("spec",))
def _ext_ctr_stage(chips_all, ii, bb, pp, pn_packed, spec: PolarSpec):
    """Device-resident extended-counter decode: gather + despread + CRC.

    ``chips_all`` is the (B, 4, P, FRAME_LEN) device chip tensor the
    verify stage already exported; ``pn_packed`` ships the per-row
    payload PN as PACKED bits (128 B/row, MSB-first like np.packbits)
    instead of downloading ~5 KB/row of chips to the host only to
    re-upload them next to f32 PN symbols.
    Returns ONE (rows, 1 + info_len/8) uint8 host row: crc_ok | packed
    info bits (byte layout identical to ops/polar.pack_info_bits).
    """
    chips = chips_all[ii, bb, pp].astype(jnp.float32)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (pn_packed[:, :, None] >> shifts) & 1
    pn_sy = 2.0 * bits.reshape(pn_packed.shape[0], -1).astype(
        jnp.float32) - 1.0
    info, crc_ok = _llr_hard_stage(chips, pn_sy, spec)
    ib = info.reshape(info.shape[0], -1, 8).astype(jnp.uint8)
    packed = jnp.sum(ib << shifts, axis=-1).astype(jnp.uint8)
    return jnp.concatenate(
        [crc_ok.astype(jnp.uint8)[:, None], packed], axis=1)


def _key_tables(sec: SecureChannel, hop, max_ctr: int):
    """Per-key device tables: payload PN bits + hop band for every counter."""
    ctrs = np.arange(max_ctr, dtype=np.int64)
    pn = sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L :]
    return (jnp.asarray(pn.astype(np.int8)),
            jnp.asarray(hop.indices(ctrs).astype(np.int32)))


def _pack_host_row(sel_ok, sel_ctr, blob):
    """(B,) ok + (B,) int32 ctr + (B, 55) blob -> ONE (B, 60) uint8 row.

    The host verdict needs three tiny per-clip outputs; downloading them
    separately pays the device-to-host latency three times per batch.
    Byte layout: ok(1) | ctr big-endian(4) | blob(55).
    """
    ctr_bytes = jnp.stack(
        [(sel_ctr >> s) & 0xFF for s in (24, 16, 8, 0)],
        axis=-1).astype(jnp.uint8)
    return jnp.concatenate(
        [sel_ok.astype(jnp.uint8)[:, None], ctr_bytes, blob], axis=1)


def _resolve_counters(hdr_ok, lo16, ctr_est, hop_table, band_ids, max_ctr):
    """Header-gated absolute + time-estimate fallback counter resolution.

    All args broadcast against a (..., band, ...) candidate lattice; returns
    (ctr, any_match).  Mirrors the block in ``_batch_verify_stage`` (kept
    inline there -- its shapes are pinned by round-1 tests).
    """
    lo16c = jnp.clip(lo16, 0, max_ctr - 1)
    hdr_resolved = hdr_ok & (hop_table[lo16c] == band_ids) & (lo16 < max_ctr)
    deltas = jnp.arange(-WIDE_DELTA, WIDE_DELTA + 1, dtype=jnp.int32)
    cand = jnp.clip(ctr_est[..., None] + deltas, 0, max_ctr - 1)
    match_nohdr = hop_table[cand] == band_ids[..., None]
    dist = jnp.abs(deltas) + jnp.where(match_nohdr, 0, 1 << 20)
    j = jnp.argmin(dist, axis=-1)
    ctr_fb = jnp.take_along_axis(cand, j[..., None], axis=-1)[..., 0]
    ctr = jnp.where(hdr_resolved, lo16c, ctr_fb)
    return ctr, hdr_resolved | jnp.any(match_nohdr, axis=-1)


@functools.partial(jax.jit,
                   static_argnames=("peaks", "span", "spec", "sync_dtype"))
def _batch_verify_stage_v2(
    x: jnp.ndarray,           # (B, Tpad) float32 clips, zero padded
    n_valid: jnp.ndarray,     # (B,) int32 true lengths
    templates: jnp.ndarray,   # (4, 63*S) sync templates
    m_stack: jnp.ndarray,     # (4, NP, 1215, span) LS demod, 2 lam profiles
    pre_sy: jnp.ndarray,      # (63,)
    hdr_pn_sy: jnp.ndarray,   # (128,)
    pn_table: jnp.ndarray,    # (MAX_CTR, 1024) int8 payload PN bits
    hop_table: jnp.ndarray,   # (MAX_CTR,) int32 band index per counter
    peaks: int,
    span: int,
    spec: PolarSpec,
    sync_dtype=jnp.bfloat16,
):
    """One-dispatch v2 (oversampled-profile) batch verification.

    Differences from the compat stage: oversampled sync templates and LS
    matrices (no refinement -- the in-band energy concentration makes the
    raw inversion mild, models/robust.py), the STANDARD polar info-set
    convention, and a per-clip best-LLR row exported for the host-driven
    SCL fallback (v2 leans on the list decoder under impairment, so the
    soft row ships packed instead of the full LLR lattice).
    """
    B, T = x.shape

    # bf16 sync by default: the 504-tap conv over the whole padded batch
    # is the largest contraction of the v2 stage; scores only rank/gate
    # peak positions, so bf16 tensor cores are free accuracy-wise.
    # ``sync_dtype`` exists so precision-sensitivity experiments (e.g.
    # the timescale-residual attribution) can flip it without editing.
    corr = demod.normalized_xcorr(x, templates,
                                  compute_dtype=sync_dtype)  # (B, 4, Tc)
    lag = jnp.arange(corr.shape[-1])
    corr = jnp.where(lag[None, None, :] <= (n_valid[:, None, None] - span),
                     corr, -jnp.inf)
    idx, val = demod.topk_nms(corr, peaks, span // 2)       # (B, 4, K)
    valid = jnp.isfinite(val)

    starts = jnp.clip(idx, 0, T - span)
    win = demod.slice_windows(x, starts, span)              # (B, 4, K, span)
    win = win * jax.lax.rsqrt(jnp.mean(win * win, -1, keepdims=True) + 1e-30)

    chips = jnp.einsum("bfkw,fpcw->bfpkc", win, m_stack,
                       precision=jax.lax.Precision.HIGHEST)  # (B,4,NP,K,1215)

    hdr_ok, lo16, hdr_score = demod.header_decode(chips, hdr_pn_sy)
    ctr_est = jnp.round(idx.astype(jnp.float32) / span).astype(jnp.int32)
    max_ctr = pn_table.shape[0]
    band_ids = jnp.arange(4, dtype=jnp.int32)[None, :, None, None]
    ctr, any_match = _resolve_counters(
        hdr_ok, lo16, ctr_est[:, :, None, :], hop_table, band_ids, max_ctr)

    pn_sy = 2.0 * pn_table[ctr].astype(jnp.float32) - 1.0  # (B,4,NP,K,1024)
    llr = demod.payload_llr(chips, pn_sy)
    info, crc_ok = hard_decode_batch(llr, spec)
    row_ok = valid[:, :, None, :] & any_match
    crc_ok = crc_ok & row_ok

    # first CRC-passing candidate per clip, payload packed on device
    flat_ok = crc_ok.reshape(B, -1)
    best = jnp.argmax(flat_ok, axis=-1)
    sel_ok = jnp.take_along_axis(flat_ok, best[:, None], -1)[:, 0]
    sel_info = jnp.take_along_axis(
        info.reshape(B, -1, info.shape[-1]), best[:, None, None], 1)[:, 0]
    sel_ctr = jnp.take_along_axis(ctr.reshape(B, -1), best[:, None], -1)[:, 0]
    pow2 = (2 ** jnp.arange(7, -1, -1, dtype=jnp.int32))
    blob = jnp.sum(sel_info.reshape(B, -1, 8) * pow2, axis=-1).astype(
        jnp.uint8)
    host_packed = _pack_host_row(sel_ok, sel_ctr, blob)

    # per-clip top-R soft rows (highest mean |LLR| among plausible rows)
    # for the SCL fallback -- (B, R, 1024) + counters, ~16 KB/clip to host.
    # R rows rather than 1: under band-selective impairment (e.g. the MP3
    # lowpass killing the >=16 kHz hops) the loudest-LLR row is often a
    # dead band's garbage; the surviving frame sits a few rows down.
    R = min(4, 4 * llr.shape[2] * peaks)
    quality = jnp.where(row_ok, jnp.mean(jnp.abs(llr), axis=-1), -jnp.inf)
    qv, qtop = jax.lax.top_k(quality.reshape(B, -1), R)     # (B, R)
    scl_llr = jnp.take_along_axis(
        llr.reshape(B, -1, llr.shape[-1]), qtop[..., None], 1)
    scl_ctr = jnp.take_along_axis(ctr.reshape(B, -1), qtop, -1)

    # evidence bytes for the host futility gate (_finish_ladder): a clip
    # with NO readable header and a best soft row at the pure-noise |LLR|
    # level cannot be rescued by any escalation rung, so the host skips
    # the ladder for it.  Shipped inside host_packed -- a separate
    # download would pay another device-to-host round trip.
    any_hdr = jnp.any(hdr_ok & row_ok, axis=(1, 2, 3))      # (B,)
    q_best = jnp.where(jnp.isfinite(qv[:, 0]), qv[:, 0], 0.0)
    host_packed = jnp.concatenate(
        [host_packed, any_hdr.astype(jnp.uint8)[:, None],
         jax.lax.bitcast_convert_type(q_best.astype(jnp.float32),
                                      jnp.uint8)], axis=1)  # (B, 65)

    return dict(
        ok=sel_ok, blob=blob, blob_ctr=sel_ctr,
        host_packed=host_packed,
        scl_llr=scl_llr, scl_ctr=scl_ctr,
        crc_ok=crc_ok, ctr=ctr,
        peak_idx=idx, peak_val=val,
        hdr_ok=hdr_ok, hdr_score=hdr_score,
        hdr_lo16=lo16,             # (B, 4, NP, K) raw 16-bit header reads
        chips=chips,               # (B, 4, NP, K, 1215) -- extended pass
    )


class BatchVerifier:
    """High-throughput multi-clip verifier (one device program per batch)."""

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 max_ctr: int = DEFAULT_MAX_CTR,
                 peaks: int = DEFAULT_PEAKS,
                 accept_legacy_plaintext: bool = False) -> None:
        self.fs = fs
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self.peaks = int(peaks)
        self.accept_legacy_plaintext = bool(accept_legacy_plaintext)

        self._spec = polar_spec()
        self._templates = jnp.asarray(demod.sync_templates(fs))
        md, _ = demod.all_demod_matrices(fs)
        self._m_direct = jnp.asarray(md[:, 0])     # exact-inversion profile
        self._t_fwd = jnp.asarray(demod.all_forward_matrices(fs))
        self._pre_sy = jnp.asarray(bits_to_bpsk(mls63()))
        self._hdr_pn_sy = jnp.asarray(bits_to_bpsk(self.sec.pn_bits(0, HDR_L)))

        # per-key device tables: one AES sweep covers every counter
        self._pn_table, self._hop_table = _key_tables(
            self.sec, self._hop, max_ctr)

    # ------------------------------------------------------------------ API
    def run_device(self, clips: np.ndarray, n_valid: np.ndarray | None = None):
        """Raw device stage outputs for a (B, T) float32 batch."""
        clips = jnp.asarray(clips, dtype=jnp.float32)
        B, T = clips.shape
        if n_valid is None:
            n_valid = np.full(B, T, dtype=np.int32)
        return _batch_verify_stage(
            clips, jnp.asarray(n_valid, dtype=jnp.int32),
            self._templates, self._m_direct, self._t_fwd,
            self._pre_sy, self._hdr_pn_sy, self._pn_table, self._hop_table,
            peaks=self.peaks,
        )

    def verify_batch(self, clips: np.ndarray,
                     n_valid: np.ndarray | None = None, *,
                     expected_nonce: bytes | None = None,
                     max_stream_frames: int = 1 << 20,
                     details: dict[int, ClipDetail] | None = None
                     ) -> np.ndarray:
        """(B, T) float32 clips -> (B,) bool verdicts.

        Clips whose frame counters exceed the device PN table (``max_ctr``
        frames ~ 7 min at the default) are resolved by the host-side
        extended-counter pass: the 16-bit header pins ``ctr mod 2**16``,
        so candidates ``lo16 + m * 2**16`` up to ``max_stream_frames``
        (default ~7.4 h of stream, matching RxParams.max_stream_frames)
        are despread with freshly generated PN and hard-decoded in one
        extra dispatch -- only for clips the table pass missed.

        ``details`` (optional dict) collects a ``ClipDetail`` per
        accepted clip index: session nonce, frame counter, accepting
        rung.
        """
        with Timer("pipeline.compat_batch"):
            out = self.run_device(clips, n_valid)
            verdicts, _ = self.finish_host_detailed(
                out, expected_nonce=expected_nonce, details=details)
        # n_valid == 0 rows are bucket padding (monitor / retry callers):
        # they can never verify, so they must not trigger escalation
        real = (np.asarray(n_valid) > 0 if n_valid is not None
                else np.ones(verdicts.shape, bool))
        pending = real & ~verdicts
        if pending.any():
            verdicts |= self._extended_counter_pass(
                out, pending, expected_nonce, max_stream_frames,
                details=details)
        _LOG.event("compat_batch", B=int(verdicts.size),
                   accepted=int(verdicts.sum()))
        return verdicts

    def _extended_counter_pass(self, out, mask: np.ndarray,
                               expected_nonce: bytes | None,
                               max_stream_frames: int,
                               details: dict[int, ClipDetail] | None = None
                               ) -> np.ndarray:
        """Header-gated ``lo16 + m*2**16`` fan-out beyond the PN table.

        Profile-agnostic: candidate axes after (clip, band) -- offsets,
        lam profiles, peaks -- are flattened, and the hard decode runs
        under ``self._spec`` (compat or standard convention).
        """
        from echoseal_tpu.models.detector import _cand_bucket

        rescued = np.zeros(mask.shape[0], dtype=bool)
        max_ctr = self._pn_table.shape[0]
        n_mult = -(-max_stream_frames >> 16)
        if n_mult <= 0:
            return rescued
        B = mask.shape[0]
        # one download: readable headers as lo16, unreadable as -1
        lo16_or = np.asarray(jnp.where(out["hdr_ok"],
                                       out["hdr_lo16"], -1)).reshape(B, 4, -1)
        hdr_ok = (lo16_or >= 0) & mask[:, None, None]
        # vectorised candidate fan-out (VERDICT r4 weak #7: the former
        # quadruple Python loop enumerated clip x band x peak x
        # multiplier rows one at a time -- fine at n_mult=16, quadratic
        # pain on deep streams).  The remaining per-candidate host cost
        # is the keyed HMAC hop check, batched through hop.indices.
        ii0, bb0, pp0 = np.nonzero(hdr_ok)            # readable headers
        base = lo16_or[ii0, bb0, pp0].astype(np.int64)
        m = np.arange(n_mult, dtype=np.int64) << 16   # (n_mult,)
        cand = base[:, None] + m[None, :]             # (nh, n_mult)
        ok = (cand >= max_ctr) & (cand < max_stream_frames)
        if ok.any():
            band_of = self._hop.indices(cand[ok].ravel())
            ok_flat = np.zeros(cand.shape, dtype=bool)
            ok_flat[ok] = band_of == np.repeat(bb0, n_mult).reshape(
                cand.shape)[ok]
            ok = ok_flat
        sel_r, sel_m = np.nonzero(ok)
        rows = list(zip(ii0[sel_r].tolist(), bb0[sel_r].tolist(),
                        pp0[sel_r].tolist(), cand[sel_r, sel_m].tolist()))
        if not rows:
            return rescued

        # gather the needed rows ON DEVICE, then download only those
        # (~5 KB/row) -- not the whole (B, 4, cand, 1215) tensor.  The
        # index arrays are padded to a power-of-two bucket: an arbitrary
        # row count would compile a fresh gather program per distinct
        # shape.
        nr = len(rows)
        bucket = _cand_bucket(nr)
        ii = np.zeros(bucket, dtype=np.int32)
        bb = np.zeros(bucket, dtype=np.int32)
        pp = np.zeros(bucket, dtype=np.int32)
        ii[:nr] = [r[0] for r in rows]
        bb[:nr] = [r[1] for r in rows]
        pp[:nr] = [r[2] for r in rows]
        chips_dev = out["chips"].reshape(B, 4, -1, FRAME_LEN)
        # decode ON DEVICE: the chips never leave the chip.  The PN for
        # each candidate counter ships UP as packed bits (128 B/row) and
        # one (rows, 1+info_len/8) uint8 verdict row ships down -- the
        # old shape downloaded ~5 KB/row of chips only to re-upload them
        # beside f32 PN symbols (the clip-relative AWGN row, where CRC-8
        # flukes fan out candidates, spent most of its ladder there).
        ctrs = np.asarray([c for _, _, _, c in rows], dtype=np.int64)
        uniq, inv = np.unique(ctrs, return_inverse=True)
        pn = self.sec.pn_bits_batch(uniq, FRAME_LEN)[:, PRE_L + HDR_L :]
        pnp = np.full((bucket, pn.shape[1] // 8), 0xFF, np.uint8)
        pnp[:nr] = np.packbits(pn[inv].astype(np.uint8), axis=-1)
        with Timer("pipeline.ext_ctr_decode"):
            host_row = np.asarray(_ext_ctr_stage(
                chips_dev, jnp.asarray(ii), jnp.asarray(bb),
                jnp.asarray(pp), jnp.asarray(pnp), self._spec))
        crc_ok = host_row[:nr, 0] > 0
        info_bytes = host_row[:nr, 1:]
        for r in np.flatnonzero(crc_ok):
            i = rows[r][0]
            if rescued[i]:
                continue
            nonce = self._accept_blob(info_bytes[r].tobytes(),
                                      int(ctrs[r]), expected_nonce)
            if nonce is not None:
                rescued[i] = True
                if details is not None:
                    details[i] = ClipDetail(nonce, int(ctrs[r]), "ext_ctr")
        return rescued

    def finish_host(self, out, *,
                    expected_nonce: bytes | None = None) -> np.ndarray:
        """AEAD verdicts from the device outputs (downloads ~60 B/clip)."""
        return self.finish_host_detailed(out, expected_nonce=expected_nonce)[0]

    def finish_host_detailed(self, out, *,
                             expected_nonce: bytes | None = None,
                             details: dict[int, ClipDetail] | None = None,
                             _packed: np.ndarray | None = None):
        """(verdicts (B,) bool, nonces (B,) list[bytes|None]).

        Unlike the single-clip detector (which latches the first authentic
        session nonce -- models/detector.py), a serving batch mixes clips
        from many sessions, so the anti-replay policy is the CALLER's:
        either pass ``expected_nonce`` to enforce one session across the
        batch, or consume the returned per-clip nonces and apply a
        per-stream latch upstream.  Without either, a frame sealed in a
        different session still verifies (AEAD+ctr only) -- by design for
        multi-tenant serving, but callers wanting the reference detector's
        replay protection must use one of the two hooks.
        """
        if _packed is None:
            _packed = np.asarray(out["host_packed"])
        packed = _packed.astype(np.int64)
        ok = packed[:, 0] > 0
        ctrs = ((packed[:, 1] << 24) | (packed[:, 2] << 16)
                | (packed[:, 3] << 8) | packed[:, 4])
        # columns past the blob are the v2 evidence bytes
        # (_parse_evidence); the blob width follows the profile's
        # payload rate (55 bytes at K=448, 44 at the K=360 floor)
        bw = self._spec.info_len // 8
        blobs = packed[:, 5:5 + bw].astype(np.uint8)
        verdicts = np.zeros(ok.shape[0], dtype=bool)
        nonces: list[bytes | None] = [None] * ok.shape[0]
        sel = np.flatnonzero(ok)
        accepted = self._accept_blobs(blobs[sel], ctrs[sel], expected_nonce)
        for i, nonce in zip(sel, accepted):
            if nonce is not None:
                verdicts[i] = True
                nonces[i] = nonce
                if details is not None:
                    details[int(i)] = ClipDetail(nonce, int(ctrs[i]), "hard")
        return verdicts, nonces

    def _accept_blob(self, blob: bytes, ctr: int,
                     expected_nonce: bytes | None) -> bytes | None:
        """``_accept_blobs`` for one payload."""
        return self._accept_blobs(np.frombuffer(blob, dtype=np.uint8)[None],
                                  [ctr], expected_nonce)[0]

    def _accept_blobs(self, blobs: np.ndarray, ctrs,
                      expected_nonce: bytes | None) -> list[bytes | None]:
        """AEAD open + magic/ctr (+optional nonce) ladder, one per row.

        ``blobs`` is (M, L) uint8; the AEAD opens share one vectorised
        keystream pass (core/crypto.py).  Returns the session nonce of
        each accepted row, None elsewhere.

        The reference's "legacy plaintext" acceptance (an unsealed payload
        passing on magic+ctr alone, rtwm/detector.py:206-212) bypasses AEAD,
        and the serving tier routes many decoder candidates through here
        (SCL fallback, extended counters) -- so it is OFF unless the caller
        opted in at construction (``accept_legacy_plaintext=True``).
        """
        out: list[bytes | None] = []
        opened = self.sec.open_any_layout_many(blobs)
        for blob, ctr, (plain, _) in zip(blobs, ctrs, opened):
            if plain is None and self.accept_legacy_plaintext and \
                    blob[:4].tobytes() == MAGIC:
                plain = blob.tobytes()
            if (plain is None or not plain.startswith(MAGIC)
                    or int.from_bytes(plain[4:8], "big") != int(ctr)):
                out.append(None)
                continue
            nonce = plain[8:16]
            out.append(None if expected_nonce is not None
                       and nonce != expected_nonce else nonce)
        return out


class RobustBatchVerifier(BatchVerifier):
    """Batched v2 (robust-profile) verification -- BASELINE config 5 scale.

    One device dispatch covers the whole batch through sync, LS demod (both
    regularisation profiles), header/counter resolution, LLR and the
    hard-decision polar pass; a second, optional dispatch runs the
    vectorised SCL list decoder over the per-clip best soft row for every
    clip the hard pass missed (v2's noise margin lives in the list decoder
    -- see tests/test_scl_proof.py).  Host work stays at AEAD opens plus
    ~4 KB/clip of downloads.

    Shares the counter tables, host finisher and anti-replay hooks with the
    compat ``BatchVerifier`` (same payload format and PN/hop schedule --
    the profiles differ only in waveform and polar info-set convention).
    """

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 max_ctr: int = DEFAULT_MAX_CTR, peaks: int = 4,
                 list_size: int = 32, profile=None,
                 table_dtype: str | None = None,
                 sync_dtype: str | None = None,
                 accept_legacy_plaintext: bool = False,
                 futility_qfloor: float | None = None) -> None:
        from echoseal_tpu.core.profiles import ROBUST, profile_spec
        from echoseal_tpu.models.robust import (
            LAM_PROFILES,
            resolve_table_dtype,
            robust_demod_matrix,
            robust_templates,
        )

        self.fs = fs
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self.peaks = int(peaks)
        self.accept_legacy_plaintext = bool(accept_legacy_plaintext)
        self.profile = ROBUST if profile is None else profile
        self.span = self.profile.span
        self._spec = profile_spec(self.profile)
        self._list_size = int(list_size)
        self._futility_qfloor = (float("inf") if futility_qfloor is None
                                 else float(futility_qfloor))
        self._resamplers: dict[int, object] = {}

        S = self.profile.oversample
        self._templates = jnp.asarray(robust_templates(fs, S))
        m = np.stack([
            np.stack([robust_demod_matrix(lo, hi, fs, S, lam)
                      for lam in LAM_PROFILES])
            for lo, hi in BAND_PLAN
        ])
        self._m_stack = jnp.asarray(m, dtype=resolve_table_dtype(table_dtype))
        # sync-conv compute precision: bf16 (tensor cores) unless overridden
        self._sync_dtype = resolve_sync_dtype(sync_dtype)
        self._pre_sy = jnp.asarray(bits_to_bpsk(mls63()))
        self._hdr_pn_sy = jnp.asarray(bits_to_bpsk(self.sec.pn_bits(0, HDR_L)))
        self._pn_table, self._hop_table = _key_tables(
            self.sec, self._hop, max_ctr)

    # ------------------------------------------------------------------ API
    def run_device(self, clips: np.ndarray, n_valid: np.ndarray | None = None,
                   *, sync_dtype=None):
        clips = jnp.asarray(clips, dtype=jnp.float32)
        B, T = clips.shape
        if n_valid is None:
            n_valid = np.full(B, T, dtype=np.int32)
        return _batch_verify_stage_v2(
            clips, jnp.asarray(n_valid, dtype=jnp.int32),
            self._templates, self._m_stack, self._pre_sy, self._hdr_pn_sy,
            self._pn_table, self._hop_table,
            peaks=self.peaks, span=self.span, spec=self._spec,
            sync_dtype=(self._sync_dtype if sync_dtype is None
                        else resolve_sync_dtype(sync_dtype)),
        )

    def verify_batch(self, clips: np.ndarray,
                     n_valid: np.ndarray | None = None, *,
                     expected_nonce: bytes | None = None,
                     use_scl: bool = True,
                     max_stream_frames: int = 1 << 20,
                     fs_in: int | None = None,
                     details: dict[int, ClipDetail] | None = None
                     ) -> np.ndarray:
        """Batch verdicts; ``fs_in`` accepts non-48 kHz captures.

        With ``fs_in`` (e.g. 44100), the batch is rate-converted ON
        DEVICE (ops/resample.py, scipy-parity polyphase) before the
        verify stage -- the serving-tier equivalent of the single-clip
        ``verify(audio, fs_in)`` host resample, without a host
        resample + re-upload per batch.  ``n_valid`` is given in INPUT
        samples.  (``verify_batch_recover`` expects 48 kHz clips: its
        host-fallback resample path composes with ingest conversion
        upstream, as the CLI does.)
        """
        if fs_in is not None and int(fs_in) != self.fs:
            if n_valid is None:
                n_valid = np.full(len(clips), np.shape(clips)[-1],
                                  np.int32)
            clips, n_valid = self._ingest(clips, n_valid, int(fs_in))
        out = self.run_device(clips, n_valid)
        real = (np.asarray(n_valid) > 0) if n_valid is not None else None
        return self._finish_ladder(out, expected_nonce, use_scl,
                                   max_stream_frames, real=real,
                                   details=details)

    def _ingest(self, clips, n_valid, fs_in: int):
        """Device rate conversion ``fs_in`` -> ``self.fs`` for a batch.

        The output width is padded up to a 4096 bucket: the verify
        stage compiles per clip width (a long compile each), so an
        arbitrary ``ceil(t_in * up/down)`` width must not leak out of
        here.  (4096, not a larger bucket, so callers can land on the
        conv-honest smooth widths like 184320 = 4096*45 that the 48 kHz
        paths compile.)  The pad region is exactly zero (the resampler
        masks past ``n_out``) and sits past ``n_valid``, which every
        downstream stage masks by.
        """
        from math import gcd

        from echoseal_tpu.ops.resample import DeviceResampler

        g = gcd(self.fs, fs_in)
        up, down = self.fs // g, fs_in // g
        # decimating ratios reduce to tiny lattices (96 kHz -> up=1,
        # down=2) whose window tensor would be ~(width/down)x the input
        # batch -- scale the lattice so each window yields >=128 outputs
        # and the overhang stays a small fraction of the stride
        m = -(-128 // up)
        up, down = up * m, down * m
        t_in = int(np.shape(clips)[-1])
        rs = DeviceResampler(up, down, down, t_in)  # cheap; stages cached
        y, n_out = rs(jnp.asarray(clips, dtype=jnp.float32), down)
        bucket = -(-n_out // 4096) * 4096
        if y.shape[-1] < bucket:
            y = jnp.pad(y, ((0, 0), (0, bucket - y.shape[-1])))
        nv = np.minimum(np.asarray(n_valid).astype(np.int64) * up // down,
                        n_out).astype(np.int32)
        return y[:, :bucket], nv

    def _parse_evidence(self, raw: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(any_hdr (B,) bool, q_best (B,) f32) from the packed host row.

        The evidence bytes sit past the ok(1)+ctr(4)+blob row; a row
        without them (compat-width, from monitor/retry callers) fails
        OPEN -- never drop a clip for lack of instrumentation.
        """
        row_w = 5 + self._spec.info_len // 8
        if raw.shape[1] < row_w + 5:   # no evidence bytes appended
            n = raw.shape[0]
            return np.ones(n, bool), np.full(n, np.inf, np.float32)
        any_hdr = raw[:, row_w] > 0
        q = np.ascontiguousarray(
            raw[:, row_w + 1:row_w + 5]).view(np.float32).ravel()
        return any_hdr, q

    # near-start headerless rescue (see _near_start_mask): a clip
    # escalates when >= MIN_ALIGNED sync peaks share one phase mod the
    # frame span within +-PHASE_TOL samples and the cluster starts
    # inside the wide counter window
    NEAR_START_MIN_ALIGNED = 6
    NEAR_START_PHASE_TOL = 32

    def _near_start_mask(self, out) -> np.ndarray:
        """Auto-detect the near-start headerless-rescue corner.

        A clip with NO readable header can still be counter-resolved
        when it was cut within the wide fallback window of the stream
        START: the time-estimate fallback (``_resolve_counters``) maps
        peak position -> counter there, which is exactly the logic the
        reference applies at rtwm/detector.py:122-142.  Closing VERDICT
        r4 next #5: such clips re-enter the SCL escalation without the
        manual ``futility_qfloor`` valve.

        The cheap host-side evidence that separates this corner from
        hopeless noise (which the q-statistic measurably does NOT --
        see ``_finish_ladder``): true sync peaks sit on the stream's
        frame lattice, ``idx = ctr*span + phase`` (span = frame pacing
        in samples, ``profile.span``) with ONE shared phase and small
        jitter, so the largest cluster of peak phases mod span holds
        most of the 16 candidate peaks (measured on the serving
        fixture: 8-13 of 16 aligned; the stragglers are junk peaks a
        plain circular-concentration statistic would drown in).  Noise
        argmaxes are uniform mod span: with tol=32 the per-pair
        alignment rate is ~65/9720, so P(cluster >= 6 of 16) ~
        C(15,5) * (65/9720)^5 * 16 ~ 6e-7 -- a 1k hopeless-noise batch
        escalates ~0 clips and rejection cost stays at the hard pass
        (the futility gate's whole point).  Costs one lazy (B, 4, P)
        int32+f32 download, only reached when some real clip is
        pending WITHOUT a header.
        """
        span = self.span        # v2 frame pacing in samples (ctr lattice)
        tol = self.NEAR_START_PHASE_TOL
        idx = np.asarray(out["peak_idx"]).reshape(len(out["peak_idx"]), -1)
        val = np.asarray(out["peak_val"]).reshape(idx.shape)
        valid = np.isfinite(val)
        ph = idx % span                                     # (B, K)
        d = np.abs(ph[:, :, None] - ph[:, None, :])
        d = np.minimum(d, span - d)                         # circular
        pair_ok = (d <= tol) & valid[:, :, None] & valid[:, None, :]
        cluster = pair_ok.sum(axis=2)                       # (B, K)
        anchor = np.argmax(cluster, axis=1)                 # cluster rep
        # the counter estimate must be resolvable for the CLUSTER's
        # peaks (junk peaks far into the clip don't matter)
        in_cluster = np.take_along_axis(
            pair_ok, anchor[:, None, None], axis=1)[:, 0]   # (B, K)
        ctr_est = np.rint(idx / span)
        ctr_min = np.where(in_cluster, ctr_est, np.inf).min(axis=1)
        return ((cluster.max(axis=1) >= self.NEAR_START_MIN_ALIGNED)
                & (ctr_min < WIDE_DELTA))

    def _finish_ladder(self, out, expected_nonce, use_scl: bool,
                       max_stream_frames: int,
                       real: np.ndarray | None = None,
                       details: dict[int, ClipDetail] | None = None
                       ) -> np.ndarray:
        """Hard verdicts -> futility gate -> staged SCL -> extended ctrs.

        ``real`` masks bucket-padding rows (n_valid == 0, from the
        monitor / retry callers): they can never verify, so without the
        mask every padded dispatch would run the whole escalation ladder
        even when all real clips already passed the hard stage.

        The futility gate: a clip with no readable header in ANY
        candidate row cannot be rescued by escalation -- serving clips
        are mid-stream cuts, so the counter comes from the 16-bit
        header (the time-estimate fallback only covers near-start
        clips), and with a wrong counter both the SCL fallback (wrong
        PN despread) and the extended pass (header-driven by
        construction) decode garbage.  Skipping header-less clips makes
        rejection cost ~the hard pass alone (the clip-relative AWGN
        rows spent most of their time escalating on a physically
        undecodable channel before this).  Measured at B=1024: every
        escalation-rescued clip across the mp3/reverb rows had a readable
        header (rescued hdr_frac 1.0) while the undecodable AWGN rows read
        0.1-0.3%; best-row mean |LLR| does NOT separate the populations
        (host-tone leakage yields confident garbage: rejected q0 up to
        15.2 vs rescued minimum 2.3), so the optional
        ``futility_qfloor`` rescue valve is OFF (+inf) by default.

        The NEAR-START corner is auto-rescued (VERDICT r4 next #5): a
        clip cut within the wide window of the stream START can have
        its counter resolved by the time-estimate fallback even with
        every header noise-killed (the same logic the reference
        applies at rtwm/detector.py:122-142), so headerless clips
        whose sync evidence is frame-LATTICE-consistent and whose best
        peak implies ``ctr_est < WIDE_DELTA`` re-enter the SCL
        escalation (``_near_start_mask``).  The lattice test is what
        keeps hopeless-noise rejection cost unchanged -- see its
        docstring for the false-positive math.  ``futility_qfloor=0.0``
        remains the manual valve: every finite-q clip escalates, at
        the pre-gate ladder cost (tests/test_pipeline.py pins both).
        """
        with Timer("pipeline.v2_batch"):
            raw = np.asarray(out["host_packed"])
            verdicts, _ = self.finish_host_detailed(
                out, expected_nonce=expected_nonce, details=details,
                _packed=raw)
        if real is None:
            real = np.ones(verdicts.shape, bool)
        n_hard = int(verdicts.sum())
        any_hdr, q_best = self._parse_evidence(raw)
        evidence = any_hdr | (q_best >= self._futility_qfloor)
        pending_nohdr = real & ~verdicts & ~evidence
        if use_scl and pending_nohdr.any():
            evidence |= pending_nohdr & self._near_start_mask(out)
        n_futile = int((real & ~verdicts & ~evidence).sum())
        pending = real & ~verdicts & evidence
        if use_scl and pending.any():
            with Timer("pipeline.v2_scl"):
                verdicts |= self._scl_fallback(out, pending, expected_nonce,
                                               details=details)
            pending = real & ~verdicts & evidence
        # the extended-counter pass can only act on readable headers
        pending &= any_hdr
        if pending.any():
            with Timer("pipeline.v2_ext_ctr"):
                verdicts |= self._extended_counter_pass(
                    out, pending, expected_nonce, max_stream_frames,
                    details=details)
        _LOG.event("v2_batch", B=int(verdicts.size), hard=n_hard,
                   futile=n_futile, accepted=int(verdicts.sum()))
        return verdicts

    # ------------------------------------------------- time-scale recovery
    def verify_batch_recover(self, clips: np.ndarray,
                             n_valid: np.ndarray | None = None, *,
                             expected_nonce: bytes | None = None,
                             fs_in: int | None = None) -> np.ndarray:
        """``verify_batch`` plus batched +-5% playback-speed recovery.

        Mirrors the single-clip ladder (models/robust.py verify_detailed)
        at batch granularity: clips the plain pass misses get a sync-only
        scaled-template scan (batched: failing rows gathered ON DEVICE
        from the already-uploaded clip batch, scanned in chunks of <=128
        clips per dispatch -- not one dispatch per clip, each paying a
        fixed overhead + a 640 KB upload),
        are group-resampled per recovered factor on the host (one
        polyphase call per distinct factor), re-verified in one dispatch,
        and still-failing clips get chained inter-peak-spacing
        refinement (two rounds -- the single-clip ladder chains one per
        coarse candidate).

        ``fs_in`` composes the device ingest conversion with recovery
        (VERDICT r3 weak #6: a 44.1 kHz capture that was ALSO played at
        the wrong speed previously needed a host-side resample before
        this call).  The device scan/retry paths run on the ingested
        48 kHz batch; the host-fallback resample path (factor groups
        outside the compiled +-5% device family) corrects straight from
        the original-rate host clips in ONE polyphase pass
        (up = fs, down = round(fs_in * factor)).

        ``clips`` may be DEVICE-resident (a ``jax.Array``, e.g. from
        ``jax.device_put`` by a serving loop that stages batches ahead):
        the whole recovery ladder then runs without the ~740 MB/1k-batch
        host upload this call otherwise pays.  Host bytes are materialized
        lazily
        (one download) only if some recovered factor falls OUTSIDE the
        compiled +-5% device-resample family, which the scan grid never
        produces on its own.
        """
        from echoseal_tpu.models.robust import (
            FINE_CHAIN_MIN,
            SCALE_SCAN_GRID,
            _scale_scan_batch,
            estimate_timescale_from_peaks,
            scaled_template_bank,
        )

        dev_in = isinstance(clips, jax.Array)
        if not dev_in:
            clips = np.asarray(clips, dtype=np.float32)
        B, Tpad = (int(s) for s in clips.shape)
        if n_valid is None:
            n_valid = np.full(B, Tpad, dtype=np.int32)
        n_valid = np.asarray(n_valid, dtype=np.int32)

        clips_host = None if dev_in else clips
        nv_host = n_valid
        fs_host = self.fs if fs_in is None else int(fs_in)
        if fs_in is not None and int(fs_in) != self.fs:
            clips_dev, n_valid = self._ingest(clips, n_valid, int(fs_in))
            n_valid = np.asarray(n_valid, dtype=np.int32)
        elif dev_in:
            clips_dev = clips.astype(jnp.float32)
        else:
            clips_dev = jnp.asarray(clips)
        out = self.run_device(clips_dev, n_valid)
        real = n_valid > 0
        # hard verdicts ONLY here: on a time-scaled batch every clip
        # fails the hard pass AND cannot SCL-decode (the chip timing is
        # off), so the full-ladder escalation spent its whole list
        # decoding budget before the scan even ran.  Escalation moves
        # BEHIND the scan: recovered clips get
        # the full ladder inside the retry re-verify; clips the scan
        # could not place (or whose retry failed) get the deferred
        # escalation against these SAME device outputs below --
        # verdict-identical, rescue is a disjunction over attempts.
        verdicts = self._finish_ladder(out, expected_nonce, False, 0,
                                       real=real)
        fail = np.flatnonzero(real & ~verdicts)

        def finish_deferred(verdicts: np.ndarray) -> np.ndarray:
            left = real & ~verdicts
            if left.any():
                verdicts |= self._finish_ladder(
                    out, expected_nonce, True, 1 << 20, real=left)
            return verdicts

        if fail.size == 0:
            return verdicts

        bank = jnp.asarray(scaled_template_bank(
            self.fs, self.profile.oversample))
        CHUNK = 128     # sized for a 16 GB device; not re-tuned for 80 GB
        score_parts: list[np.ndarray] = []
        _scan_t = Timer("pipeline.recover_scan")
        _scan_t.__enter__()
        # ONE scan-dispatch shape per process: every chunk (including the
        # ragged last one) pads to min(CHUNK, bucket(B)).  The former
        # per-chunk power-of-two buckets (floor 1) compiled the scan
        # stage at up to 8 distinct sizes, each a fresh XLA compile; the
        # padding waste is at most one chunk's compute.
        from echoseal_tpu.models.detector import _cand_bucket as _cb

        bucket = min(CHUNK, _cb(B))
        for c0 in range(0, fail.size, bucket):
            idx = fail[c0:c0 + bucket]
            pad_idx = np.zeros(bucket, dtype=np.int32)
            pad_idx[:idx.size] = idx
            s = np.asarray(_scale_scan_batch(
                clips_dev[jnp.asarray(pad_idx)],
                jnp.asarray(n_valid[pad_idx]), bank))
            score_parts.append(s[:idx.size])
        scores = np.concatenate(score_parts)           # (n_fail, rows)
        _scan_t.__exit__()

        per = scores.reshape(fail.size, len(SCALE_SCAN_GRID), 4).max(axis=2)
        b = np.argmax(per, axis=1)
        f = np.asarray(SCALE_SCAN_GRID)[b]
        # NO evidence gate here, unlike the single-clip ladder's
        # estimate_scale: a retry row in the batched re-verify is nearly
        # free (bucketed into one dispatch), while a gated-out scaled
        # clip is lost for good -- the gate was costing ~5% accept on
        # the timescale row (VERDICT r3 weak #3).
        # A junk factor cannot false-accept (AEAD) and the deferred
        # escalation below still covers the un-scaled failure modes.
        # Clips whose scan argmax is the identity get the inter-peak-
        # spacing estimate from the ORIGINAL device outputs instead
        # (the single-clip ladder's fine0 candidate): sub-grid
        # residuals show up there, not in the 0.33%-step scan.
        peaks0 = np.asarray(jnp.where(jnp.isfinite(out["peak_val"]),
                                      out["peak_idx"], -1))
        factors: dict[int, float] = {}
        for pos, i in enumerate(fail):
            cand = float(f[pos])
            if abs(cand - 1.0) <= 1e-4:
                fine = estimate_timescale_from_peaks(peaks0[i], self.span)
                if fine is None or abs(fine - 1.0) <= FINE_CHAIN_MIN:
                    continue
                cand = float(fine)
            factors[int(i)] = cand
        # Fallback candidate queue, consumed by the refinement rounds
        # when a failed retry yields no peak-spacing estimate (measured:
        # benchmarks/timescale_attrib.py -- EVERY residual failure was
        # `wrong_factor` with exactly one attempt, the scan argmax in
        # the RECIPROCAL basin of the true correction; the retry at the
        # wrong factor shows no peaks, the refiner abstains, the clip is
        # lost).  Queue per clip: the reciprocal of the primary (the
        # scan's known aliasing mode: a template stretched by r also
        # part-correlates against a clip stretched by r), then the
        # second-best scan factor OUTSIDE the primary's basin.
        order = np.argsort(per, axis=1)[:, ::-1]
        grid = np.asarray(SCALE_SCAN_GRID)
        fallback: dict[int, list[float]] = {}
        for pos, i in enumerate(fail):
            f1 = factors.get(int(i))
            if f1 is None:      # scan says unscaled: deferred escalation
                continue        # covers it; no retry rows to feed
            alts: list[float] = []
            r = 1.0 / f1
            if 0.95 <= r <= 1.05 and abs(r - f1) > 1e-4:
                alts.append(float(r))
            for j in order[pos][1:]:
                f2 = float(grid[j])
                if (abs(f2 - 1.0) > 1e-4 and abs(f2 - f1) > 0.0034
                        and all(abs(f2 - a) > 1e-3 for a in alts)):
                    alts.append(f2)
                    break
            if alts:
                fallback[int(i)] = alts
        with Timer("pipeline.recover_retry"):
            # depth 4, not 2: the attribution data
            # (benchmarks/timescale_attrib.py) showed clips whose CORRECT-basin
            # factor was only reached by the fallback queue in the LAST
            # round, leaving no refinement budget for the final
            # sub-lattice residual; rounds with no candidates cost
            # nothing (the recursion returns on an empty factor map)
            verdicts = self._retry_scaled(clips_host, nv_host, factors,
                                          verdicts, expected_nonce,
                                          refine=4, clips_dev=clips_dev,
                                          nv_dev=n_valid, fs_host=fs_host,
                                          fallback=fallback)
        with Timer("pipeline.recover_deferred"):
            return finish_deferred(verdicts)

    # retry-lattice denominator: factors quantize to RETRY_UP-lattice
    # rationals (granularity 1/RETRY_UP = 8.3e-5, ~2.4x inside the demod's
    # ~2e-4 coherence budget).  12000, not fs=48000: the per-factor tap
    # table scales with ``up`` (1.2 MB vs 4.6 MB per factor), the 31
    # scan-grid factors are exact on both lattices
    # with IDENTICAL reduced ratios (gcd collapses them, so resample_poly
    # outputs are bit-equal), and the coarser lattice clusters per-clip
    # refinement estimates onto shared dens (one upload serves the
    # cluster).
    RETRY_UP = 12_000

    def _device_resampler(self, t_in: int):
        """Family-compiled +-5% device resampler for ``t_in``-wide clips."""
        rs = self._resamplers.get(t_in)
        if rs is None:
            from echoseal_tpu.ops.resample import DeviceResampler

            rs = DeviceResampler(self.RETRY_UP, int(self.RETRY_UP * 0.95),
                                 int(self.RETRY_UP * 1.05), t_in)
            self._resamplers[t_in] = rs
        return rs

    def _retry_scaled(self, clips, n_valid, factors: dict[int, float],
                      verdicts: np.ndarray, expected_nonce: bytes | None,
                      refine: int, clips_dev=None, nv_dev=None,
                      fs_host: int | None = None,
                      fallback: dict[int, list[float]] | None = None,
                      tried: dict[int, set] | None = None) -> np.ndarray:
        """Group-resample ``factors`` clips, re-verify, optionally refine.

        With ``clips_dev`` (the already-uploaded clip batch), the
        correction resamples ON DEVICE (ops/resample.py): the recovery
        row otherwise re-uploads every corrected clip -- twice (coarse +
        refinement pass), ~750 MB each for a fully time-scaled 1k batch.
        The device lattice is ``fs``-denominated (granularity ~2.1e-5,
        an order under the demod's ~2e-4 coherence budget), so both the
        coarse grid factors and the peak-spacing refinements stay on
        device; the host ``resample_poly`` path remains for factor
        groups outside the compiled +-5% family and for device-less
        callers, and computes the identical rational correction.
        """
        from math import gcd

        from scipy.signal import resample_poly

        from echoseal_tpu.models.robust import (
            FINE_CHAIN_MIN,
            estimate_timescale_from_peaks,
        )

        if not factors:
            return verdicts
        # the retry batch lives on the 48 kHz device timeline; the host
        # clips may be at a different capture rate (fs_host, from the
        # verify_batch_recover(fs_in=...) ingest composition)
        fs_host = self.fs if fs_host is None else int(fs_host)
        nv_dev = n_valid if nv_dev is None else np.asarray(nv_dev, np.int32)
        Tpad = (clips_dev.shape[1] if clips_dev is not None
                else clips.shape[1])
        # group by RETRY_UP-lattice denominator, not raw float factor:
        # per-clip refinement estimates that quantize to the same den
        # must share one resample dispatch (and one cached tap table)
        q = self.RETRY_UP if clips_dev is not None else self.fs
        tried = {} if tried is None else tried
        groups: dict[int, list[int]] = {}
        rep_f: dict[int, float] = {}
        for i, f in factors.items():
            key = int(round(q * f))
            tried.setdefault(i, set()).add(key)
            groups.setdefault(key, []).append(i)
            rep_f.setdefault(key, float(f))

        # device rows are concatenated ahead of host rows, so bookkeeping
        # (sel / nv2) is kept in matching (device, host) halves
        sel_d: list[int] = []
        sel_h: list[int] = []
        rows: list[np.ndarray] = []
        dev_rows: list[jnp.ndarray] = []
        nv2_d: list[int] = []
        nv2_h: list[int] = []
        # MAIN batch size: every device dispatch in the retry (the
        # resample gather and the re-verify) pads to it, so recovery
        # adds ZERO new compile shapes of either program (VERDICT r4
        # next #1 -- the former power-of-two buckets compiled each at
        # up to log2(B) sizes, the bulk of the 1298 s cache-cold
        # recovery warmup); the waste is dead rows in a dispatch, ~1 s
        # per retry round at B=1024, paid only when recovery ran.
        bucket = (int(clips_dev.shape[0]) if clips_dev is not None
                  else int(clips.shape[0]))
        rs = self._device_resampler(Tpad) if clips_dev is not None else None
        for den, members in groups.items():
            # the group key IS the denominator on the ``q`` lattice
            # (q == rs.up when a device batch exists, else self.fs)
            if rs is not None and den == rs.up:
                continue    # identity: re-verifying the same clip is a
                            # no-op and the device resampler rejects 1.0
            if rs is not None and rs.down_min <= den <= rs.down_max:
                # pad the gather to the MAIN batch size: one resample
                # compile per process (the former power-of-two buckets
                # compiled it at up to log2(B) sizes -- recovery-warmup
                # cost, VERDICT r4 next #1); the dominant den group is
                # ~the whole batch anyway on a uniformly scaled batch
                midx = np.zeros(bucket, np.int32)
                midx[: len(members)] = members
                y, n_out = rs(clips_dev[jnp.asarray(midx)], den)
                dev_rows.append(y[: len(members), :Tpad])
                L = min(n_out, Tpad)
                sel_d.extend(members)
                nv2_d.extend(min(int(int(nv_dev[i]) * rs.up / den), L)
                             for i in members)
            else:
                # straight from the original-rate host clips: the rate
                # conversion and the speed correction compose into ONE
                # rational polyphase pass (up=fs, down=fs_host*factor)
                if clips is None:
                    # device-resident caller: materialize host bytes once
                    # (only out-of-family factors reach this branch).  The
                    # materialized rows live on the 48 kHz INGESTED device
                    # timeline, not the fs_host capture rate -- rebase the
                    # host-path rate and lengths or a 44.1 kHz fs_in caller
                    # gets a spurious ~8.8% extra speed shift here.
                    clips = np.asarray(clips_dev)
                    fs_host = self.fs
                    n_valid = nv_dev
                den_h = int(round(fs_host * rep_f[den]))
                g = gcd(self.fs, den_h)
                y = resample_poly(clips[members], self.fs // g, den_h // g,
                                  axis=-1).astype(np.float32)
                L = min(y.shape[1], Tpad)
                for r in range(len(members)):
                    row = np.zeros(Tpad, np.float32)
                    row[:L] = y[r, :L]
                    rows.append(row)
                sel_h.extend(members)
                nv2_h.extend(min(int(int(n_valid[i]) * self.fs / den_h), L)
                             for i in members)
        sel = sel_d + sel_h
        nv2 = nv2_d + nv2_h
        n_rows = len(sel)
        if n_rows == 0:             # every group was the lattice identity
            return verdicts
        parts: list[jnp.ndarray] = list(dev_rows)
        if rows:
            parts.append(jnp.asarray(np.stack(rows)))
        if bucket > n_rows:
            parts.append(jnp.zeros((bucket - n_rows, Tpad), jnp.float32))
            nv2.extend([0] * (bucket - n_rows))
        batch = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        nv2_arr = np.asarray(nv2, np.int32)
        out = self.run_device(batch, nv2_arr)
        # drop THIS round's device staging buffers as soon as the stage
        # is dispatched (the runtime keeps them alive until execution
        # finishes): each refinement level otherwise pins its own
        # ~1.5 GB of batch + resampled rows down the recursion, and at
        # B=1024 x depth 4 that exhausted a 16 GB device mid-ladder
        del batch, parts, dev_rows
        vr = self._finish_ladder(out, expected_nonce, True, 1 << 20,
                                 real=nv2_arr > 0)
        for r, i in enumerate(sel):
            verdicts[i] |= vr[r]

        if refine > 0:
            # chained inter-peak-spacing refinement, depth = ``refine``
            # rounds (the single-clip ladder chains one per coarse
            # candidate; two rounds close sub-grid residuals the first
            # estimate leaves when the coarse peaks were smeared).
            # A clip whose failed retry shows NO usable spacing estimate
            # (wrong-basin factor -> no peaks) pulls its next fallback
            # candidate instead of dropping out -- the attribution data
            # (benchmarks/timescale_attrib.py) put 100% of residual
            # failures in exactly that abstention.  ``tried`` dedupes on
            # the retry lattice so a fallback that merely re-quantizes
            # to an already-attempted rational is skipped.
            # one download: invalid peaks already masked to -1 on device
            peaks_all = np.asarray(jnp.where(jnp.isfinite(out["peak_val"]),
                                             out["peak_idx"], -1))
            # this round's stage outputs (chips + soft rows, ~200 MB at
            # B=1024) are fully consumed now -- free them BEFORE the
            # recursion so only one round's outputs are ever live
            del out
            nxt: dict[int, float] = {}
            for r, i in enumerate(sel):
                if verdicts[i]:
                    continue
                cand = None
                fine = estimate_timescale_from_peaks(peaks_all[r], self.span)
                # threshold FINE_CHAIN_MIN, not 1e-4: a 1e-4 abstain
                # masked the retry lattice's own quantization residual
                # (up to ~8.3e-5 off the scan pick), losing the ~5% of
                # clips that cannot tolerate it (models/robust.py
                # FINE_CHAIN_MIN docstring;
                # benchmarks/timescale_attrib.py correct_factor class)
                # upper bound 2%: a chained estimate measures the
                # RESIDUAL after a correction was applied, so a large
                # value is estimator junk (few/noisy spacings), not
                # signal -- a wrong-basin retry's true residual is
                # ~6%+, outside the estimator's own 6% gate anyway,
                # and basin hops are the fallback queue's job.  Junk
                # chains burned the round's retry budget on factors
                # like 0.918 for a true 0.97 (sharded dryrun, tiny
                # clips) while the lattice-neighbour last resort below
                # never ran.
                if (fine is not None
                        and FINE_CHAIN_MIN < abs(fine - 1.0) <= 0.02):
                    c = factors[i] * fine
                    # k == q is the identity on the retry lattice: a
                    # chained estimate that cancels (f1 * fine -> ~1.0)
                    # must fall through to the fallback queue, not
                    # reach the resampler (which raises on factor 1.0
                    # -- crashed the round-4 attrib run on chip)
                    k = int(round(q * c))
                    if k != q and k not in tried[i]:
                        cand = c
                while cand is None and fallback and fallback.get(i):
                    c = fallback[i].pop(0)
                    k = int(round(q * c))
                    if k != q and k not in tried.get(i, set()):
                        cand = c
                if cand is None:
                    # last resort: the retry lattice's own quantization
                    # neighbours of the factor just tried.  A clip can
                    # sit a half-lattice-step (~4e-5) off its best
                    # rational and fail there while the adjacent step
                    # decodes (measured: the timescale_attrib
                    # correct_factor class -- tried 0.97 for true
                    # 1/1.031, residual 7e-5, no peak-spacing estimate
                    # to chain from); one extra row in the bucketed
                    # re-verify is nearly free.
                    k0 = int(round(q * factors[i]))
                    for k in (k0 + 1, k0 - 1):
                        if k != q and k not in tried.get(i, set()):
                            cand = k / q
                            break
                if cand is not None:
                    nxt[i] = cand
            verdicts = self._retry_scaled(clips, n_valid, nxt, verdicts,
                                          expected_nonce, refine=refine - 1,
                                          clips_dev=clips_dev, nv_dev=nv_dev,
                                          fs_host=fs_host, fallback=fallback,
                                          tried=tried)
        return verdicts

    # ----------------------------------------------------------- SCL stage
    def _scl_fallback(self, out, mask: np.ndarray,
                      expected_nonce: bytes | None,
                      details: dict[int, ClipDetail] | None = None
                      ) -> np.ndarray:
        """List-decode the exported top-R soft rows of each masked clip.

        Decodes through ``scl_decode_serving`` (ops/scl.py): the exact
        decoder by default (see that docstring for why the fast-SSCL
        mode is opt-in), with ``ECHOSEAL_SCL_SERVING`` /
        ``ECHOSEAL_SCL_IMPL`` overriding.  The ladder's contract is
        FER at an AEAD-gated accept, not list parity, so either
        decoder is admissible here.
        """
        from echoseal_tpu.ops.scl import scl_decode_serving as scl_decode

        rescued = np.zeros(mask.shape[0], dtype=bool)
        clips_f = np.flatnonzero(mask)
        if clips_f.size == 0:
            return rescued
        R = out["scl_llr"].shape[1]
        # gather the failing clips' soft rows ON DEVICE and ship LLRs +
        # counters as ONE download: every separate download pays the
        # device-to-host latency.  The shared dtype is
        # int32 (LLRs bitcast), never float: small counters bitcast to
        # f32 are subnormals, which a canonicalizing transfer/fusion
        # step could silently flush to zero.
        # bucket the failing-clip gather to a power of two: an arbitrary
        # count compiles a fresh gather per distinct shape (minutes of
        # aggregate compile over a varied serving day)
        from echoseal_tpu.models.detector import _cand_bucket

        idx_np = np.zeros(_cand_bucket(clips_f.size), dtype=np.int32)
        idx_np[: clips_f.size] = clips_f
        idx = jnp.asarray(idx_np)
        packed = jnp.concatenate(
            [jax.lax.bitcast_convert_type(out["scl_llr"][idx], jnp.int32),
             out["scl_ctr"][idx].astype(jnp.int32)[..., None]], axis=-1)
        with Timer("pipeline.scl_download"):
            host = np.asarray(packed)[: clips_f.size]  # (F, R, 1025) int32
        llr = np.ascontiguousarray(host[..., :1024]).view(
            np.float32).reshape(clips_f.size, R, 1024)
        ctrs = host[..., 1024]                    # (F, R)

        # doubly-staged decode: rows (best soft row first, rows 1..R-1
        # only for the remainder) x list size (SCL_LADDER rungs up to
        # the configured list size, each rung only on still-failing
        # clips).  The rescue set can only GROW vs a single fixed-L
        # decode of all F*R rows -- rescue is a disjunction over
        # (row, L) attempts, the final rung runs the full list size,
        # and every accept is AEAD-gated (no false accepts from extra
        # attempts).  Most clips rescue at the first (row 0, L=8) rung
        # at ~1/32 of the fixed-L cost; the device download above
        # already shipped all rows in ONE transfer.
        ladder = ([L for L in SCL_LADDER if L < self._list_size]
                  + [self._list_size])
        # ONE SCL batch shape per (process, L): every dispatch pads or
        # splits to ``chunk`` rows.  The former per-rung power-of-two
        # buckets compiled the decoder at up to 6 distinct sizes
        # (b32..b4096), each a cache-cold XLA compile.  Cap 256, not
        # 1024: compile cost grows with program size, and padding waste
        # for a late rung with few pending rows is bounded at 256 rows
        # instead of 1024.  Sized for a 16 GB device; not re-tuned for
        # 80 GB yet.
        chunk = min(256, _cand_bucket(mask.shape[0]))
        pending = np.arange(clips_f.size)
        for lo, hi in ((0, 1), (1, R)):
            for lsize in ladder:
                if pending.size == 0 or lo >= hi:
                    continue
                w = hi - lo
                sub = np.ascontiguousarray(
                    llr[pending, lo:hi]).reshape(-1, 1024)
                sub_ctr = ctrs[pending, lo:hi].reshape(-1)
                n_rows = sub.shape[0]
                pad_rows = -n_rows % chunk
                if pad_rows:
                    sub = np.concatenate(
                        [sub, np.zeros((pad_rows, sub.shape[1]),
                                       np.float32)])
                with Timer(f"pipeline.scl_decode_c{chunk}_L{lsize}"):
                    oks, bitss = [], []
                    for c0 in range(0, sub.shape[0], chunk):
                        res = scl_decode(
                            jnp.asarray(sub[c0:c0 + chunk]),
                            self._spec, lsize)
                        oks.append(np.asarray(res["crc_ok"]))
                        bitss.append(np.asarray(res["info_bits"]))
                    ok = np.concatenate(oks)[:n_rows]
                    bits = np.concatenate(bitss)[:n_rows]
                for r in range(n_rows):
                    i = clips_f[pending[r // w]]
                    if rescued[i]:
                        continue
                    for li in np.flatnonzero(ok[r]):
                        nonce = self._accept_blob(
                            pack_info_bits(bits[r, li]),
                            int(sub_ctr[r]), expected_nonce)
                        if nonce is not None:
                            rescued[i] = True
                            if details is not None:
                                details[int(i)] = ClipDetail(
                                    nonce, int(sub_ctr[r]), "scl")
                            break
                pending = pending[~rescued[clips_f[pending]]]
        return rescued
