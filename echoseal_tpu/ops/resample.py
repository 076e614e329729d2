"""Device-side rational polyphase resampler (scipy ``resample_poly`` parity).

The batched time-scale recovery ladder (models/pipeline.py
``verify_batch_recover``) corrects recovered clips by resampling at a
rational factor.  Running ``scipy.signal.resample_poly`` on the host
means re-uploading the whole corrected batch -- ~750 MB for a fully
time-scaled 1k batch, twice (coarse grid pass + fine refinement pass).
This module keeps both corrections on device.

Formulation -- "phase-table" polyphase, not upfirdn:
``resample_poly(x, up, down)`` output ``N = j*up + n`` is a K-tap dot
product (K ~ 20*max(1, down/up) + 2 for scipy's kaiser design: ~22 for
upsampling and mild correction factors, growing with decimation ratio)

    y[j*up + n] = sum_t  x[j*down + s0 + off[n] + t] * taps[n, t]

where ``off``/``taps`` depend only on the in-block phase ``n``.  So the
whole resample is: window extraction at stride ``down`` (ONE gather via
the vmapped ``dynamic_slice`` in ops/demod.slice_windows -- per-WINDOW
cost), then K shifted ``take`` ops along the window axis (each is a
single gather of ``up`` rows spanning the whole batch*blocks extent --
~K*up row-ops total, NOT per-sample) folded into an elementwise FMA.
Bandwidth-bound: ~2K passes over the batch, no matmul, no bf16 risk.
A dense ``(width, up)`` matrix formulation was tried first and matches
bit-for-bit, but wastes width/K ~ 50x the FLOPs on structural zeros.

``taps`` is built on the host from the exact FIR scipy designs (firwin,
kaiser beta 5.0, half-length ``10*max(up_r, down_r)`` on the gcd-reduced
ratio) including scipy's pre-pad/trim alignment, so outputs match
``resample_poly`` to f32 rounding (measured ~2e-7 relative).

Shape policy: ``up``, window ``width``, block count and ``K`` are
static; ``down``, ``n_out``, ``s0``, ``off`` and ``taps`` are traced.
One XLA compile covers a WHOLE factor family -- e.g. ``up=48000`` with
``down`` anywhere in [45600, 50400] gives every correction factor on a
2.1e-5 grid (well inside the v2 demod's ~2e-4 coherence budget) for a
per-factor cost of one host FIR design + a ~4.6 MB table upload, cached.

The reference has no resampling correction at all (its README.md:165
+-5% time-scale claim ships untested); the host-side polyphase path this
accelerates mirrors reference utils.py:58-66.
"""
from __future__ import annotations

import functools
from math import gcd

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["resample_plan", "resample_rows", "DeviceResampler"]

_PAD_LEFT = 64  # >= |s0| for every supported ratio (asserted in the plan)


def taps_needed(up: int, down_max: int) -> int:
    """Static tap count covering every ``down <= down_max`` on ``up``.

    scipy's FIR half-length is ``10 * max(up_r, down_r)`` on the reduced
    ratio, so taps-per-phase is bounded by ``20 * max(1, down/up) + 2``
    -- constant (~22) for upsampling and mild correction factors, and
    growing with the decimation ratio for downsampling.
    """
    return int(20 * max(1.0, down_max / up)) + 4


@functools.lru_cache(maxsize=64)
def _design(up_r: int, down_r: int) -> tuple[np.ndarray, int, int]:
    """scipy resample_poly's FIR + alignment for a reduced ratio.

    Returns ``(h, pre_pad, pre_remove)`` exactly as scipy computes them:
    ``y[n] = z[(n + pre_remove) * down_r]`` where ``z`` is the
    zero-stuffed convolution of ``x`` with ``h`` left-padded by
    ``pre_pad`` zeros.
    """
    from scipy.signal import firwin

    if up_r == down_r:
        raise ValueError("resample factor 1.0 is the identity; skip it")
    max_rate = max(up_r, down_r)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)) * up_r
    pre_pad = down_r - half_len % down_r
    pre_remove = (half_len + pre_pad) // down_r
    return h.astype(np.float64), pre_pad, pre_remove


@functools.lru_cache(maxsize=64)
def resample_plan(up: int, down: int, k_taps: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Phase table for ``resample_poly(x, up, down)`` on the ``up`` lattice.

    Returns ``(taps, off, s0)``: float32 ``taps`` of shape
    ``(up, k_taps)`` and int32 ``off`` of shape ``(up,)`` such that

        y[j*up + n] = sum_t x[j*down + s0 + off[n] + t] * taps[n, t]

    with out-of-range input indices reading zero.  ``up``/``down`` need
    not be coprime -- the FIR is designed on the reduced ratio (matching
    scipy's output exactly), then laid out on the caller's lattice so
    one static block size serves a whole factor family.
    """
    g = gcd(up, down)
    up_r, down_r = up // g, down // g
    h, pre_pad, pre_remove = _design(up_r, down_r)
    Lh = h.size
    # Output n of block 0 taps the zero-stuffed lattice at
    #   t_n = (n + pre_remove) * down_r - pre_pad      (reduced units)
    # with y[n] = sum_q x[q] * h[t_n - q*up_r]; nonzero q span
    # [ceil((t_n - Lh + 1)/up_r), floor(t_n/up_r)].  Block j shifts the
    # input window by exactly j*down (up*down_r/up_r = down).
    n = np.arange(up, dtype=np.int64)
    t_n = (n + pre_remove) * down_r - pre_pad
    q_hi = t_n // up_r
    q_lo = -(-(t_n - (Lh - 1)) // up_r)
    n_taps = int((q_hi - q_lo).max()) + 1
    if k_taps is None:
        k_taps = n_taps
    if n_taps > k_taps:
        raise ValueError(f"k_taps={k_taps} < needed {n_taps} "
                         f"for up={up}, down={down}")
    s0 = int(q_lo.min())
    off = (q_lo - s0).astype(np.int32)
    # taps[n, t] multiplies x[q_lo[n] + t]
    tt = np.arange(k_taps, dtype=np.int64)
    idx = t_n[:, None] - (q_lo[:, None] + tt[None, :]) * up_r
    valid = (idx >= 0) & (idx < Lh)
    taps = np.where(valid, h[np.clip(idx, 0, Lh - 1)], 0.0)
    return taps.astype(np.float32), off, s0


def _chunk_rows(batch: int, row: int) -> int:
    """Rows per lax.map chunk: ~128 MB of f32 per per-tap temp.

    Overridable via ``ECHOSEAL_RESAMPLE_CHUNK_ELEMS`` (tests set it tiny
    to exercise the multi-chunk path on toy shapes).
    """
    import os

    budget = int(os.environ.get("ECHOSEAL_RESAMPLE_CHUNK_ELEMS", 32 << 20))
    return max(1, min(batch, budget // row))


@functools.partial(jax.jit,
                   static_argnames=("up", "width", "n_blocks", "pad_left",
                                    "chunk"))
def _resample_stage(x: jnp.ndarray, taps: jnp.ndarray, off: jnp.ndarray,
                    s0: jnp.ndarray, down: jnp.ndarray,
                    n_out: jnp.ndarray, *, up: int, width: int,
                    n_blocks: int, pad_left: int = _PAD_LEFT,
                    chunk: int | None = None) -> jnp.ndarray:
    """(B, T) float32 -> (B, n_blocks*up) resampled, zero past ``n_out``.

    Everything factor-dependent (``taps``/``off``/``s0``/``down``/
    ``n_out``) is traced, so one compile covers every factor of a
    family.  Blocks whose window would run past the padded input are
    clamp-shifted by ``slice_windows``; their outputs all lie at or
    beyond ``n_out`` and the final mask zeroes them, so no garbage
    escapes into the valid region.
    """
    from echoseal_tpu.ops.demod import slice_windows

    B = x.shape[0]
    xp = jnp.pad(x, ((0, 0), (pad_left, width)))
    starts = (jnp.arange(n_blocks, dtype=jnp.int32) * down
              + (s0 + pad_left))
    # Device-memory policy: each per-tap gather materializes a
    # (chunk, n_blocks, up) temp.  An unrolled tap loop over the full
    # batch lets the XLA scheduler keep every gather's temp alive at once
    # -- a program of tens of GB at B=1024.  The chunk budget
    # (``_chunk_rows``) was sized for a 16 GB device and is not re-tuned
    # for 80 GB yet.  Two bounds fix that without giving up
    # the row-granular gather: chunk the batch (lax.map serializes
    # chunks) and serialize the tap loop (lax.fori_loop reuses the
    # accumulator buffer), so live temps stay ~3 chunk-sized arrays.
    row = n_blocks * up
    if chunk is None:
        chunk = _chunk_rows(B, row)
    n_ch = -(-B // chunk)
    xpc = jnp.pad(xp, ((0, n_ch * chunk - B), (0, 0)))
    xpc = xpc.reshape(n_ch, chunk, xp.shape[1])
    k_taps = taps.shape[1]

    def _tap(t, carry):
        win, acc = carry
        # ONE gather of `up` rows spanning (chunk, n_blocks) each --
        # never a per-sample index lattice (see slice_windows' docstring
        # for the per-row-op cost model on this backend).
        v = jnp.take(win, off + t, axis=-1)        # (chunk, n_blocks, up)
        col = jax.lax.dynamic_slice_in_dim(taps, t, 1, axis=1)[:, 0]
        return win, acc + v * col

    def _chunk(xc):
        win = slice_windows(
            xc, jnp.broadcast_to(starts, (chunk, n_blocks)), width)
        acc = jnp.zeros((chunk, n_blocks, up), x.dtype)
        _, acc = jax.lax.fori_loop(0, k_taps, _tap, (win, acc))
        return acc.reshape(chunk, row)

    y = jax.lax.map(_chunk, xpc).reshape(n_ch * chunk, row)[:B]
    return y * (jnp.arange(row) < n_out)


class DeviceResampler:
    """Family-compiled device resampler: ``up`` fixed, ``down`` dynamic.

    >>> rs = DeviceResampler(up=48000, down_min=45600, down_max=50400,
    ...                      t_in=184320)
    >>> y, n_out = rs(clips_dev, down=49488)    # factor 1.031 correction

    One XLA compile serves every ``down`` in range; per-factor host cost
    is one FIR design + a ~(up*K_TAPS*4)-byte table upload (lru-cached).
    """

    def __init__(self, up: int, down_min: int, down_max: int,
                 t_in: int) -> None:
        if not (0 < down_min <= down_max):
            raise ValueError("need 0 < down_min <= down_max")
        self.up = int(up)
        self.t_in = int(t_in)
        self.k_taps = taps_needed(self.up, int(down_max))
        # |s0| <= (Lh-1)/up_r + 1 <= k_taps, so this pad always covers
        # the left overhang; off.max() <= down + 1 for every admitted
        # factor, so windows never run past the width (jnp.take would
        # clamp silently) -- both asserted per-factor in __call__
        self.pad_left = max(_PAD_LEFT, self.k_taps + 8)
        self.width = int(down_max) + self.k_taps + self.pad_left
        n_out_max = -(-self.t_in * self.up // int(down_min))
        self.n_blocks = -(-n_out_max // self.up)
        self.down_min, self.down_max = int(down_min), int(down_max)
        # per-factor plan cache holding DEVICE arrays: re-calling with a
        # previously seen ``down`` must not re-upload the (up, k_taps)
        # tap table (4.6 MB at up=48000; ~131 factors in a 1k-clip
        # time-scale recovery).  LRU-capped:
        # the retry lattice admits up to down_max-down_min+1 distinct
        # denominators (~1.4 GB of device tables at up=12000), and a
        # long-lived serving process must not leak HBM to factor churn.
        self._plans: "dict[int, tuple]" = {}
        self._plans_cap = 256

    def _plan_dev(self, down: int):
        plan = self._plans.pop(down, None)
        if plan is None:
            taps, off, s0 = resample_plan(self.up, down, self.k_taps)
            if (s0 < -self.pad_left
                    or int(off.max()) + self.k_taps > self.width):
                raise ValueError(
                    f"plan for down={down} exceeds the compiled "
                    f"window (s0={s0}, off_max={int(off.max())})")
            plan = (jax.device_put(taps), jax.device_put(off), s0)
            while len(self._plans) >= self._plans_cap:
                self._plans.pop(next(iter(self._plans)))
        self._plans[down] = plan          # (re-)insert at LRU tail
        return plan

    def __call__(self, x: jnp.ndarray, down: int
                 ) -> tuple[jnp.ndarray, int]:
        down = int(down)
        if not (self.down_min <= down <= self.down_max):
            raise ValueError(f"down={down} outside compiled family "
                             f"[{self.down_min}, {self.down_max}]")
        if x.shape[-1] != self.t_in:
            raise ValueError(f"t_in={x.shape[-1]} != {self.t_in}")
        taps_dev, off_dev, s0 = self._plan_dev(down)
        n_out = -(-x.shape[-1] * self.up // down)
        y = _resample_stage(
            x, taps_dev, off_dev, jnp.int32(s0),
            jnp.int32(down), jnp.int32(min(n_out, self.n_blocks * self.up)),
            up=self.up, width=self.width, n_blocks=self.n_blocks,
            pad_left=self.pad_left,
            chunk=_chunk_rows(x.shape[0], self.n_blocks * self.up))
        return y, n_out


def resample_rows(x: jnp.ndarray, up: int, down: int) -> jnp.ndarray:
    """One-shot device ``resample_poly(x, up, down, axis=-1)``.

    Convenience wrapper (own compile per (up, down, T) family); e.g.
    44.1 kHz -> 48 kHz batch ingest is ``resample_rows(x, 160, 147)``.
    """
    one = x.ndim == 1
    if one:
        x = x[None]
    rs = DeviceResampler(up, down, down, x.shape[-1])
    y, n_out = rs(x, down)
    y = y[..., :n_out]
    return y[0] if one else y
