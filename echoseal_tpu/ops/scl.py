"""Vectorised CRC-aided successive-cancellation list (SCL) decoding.

This replaces the reference's object-graph, pointer-chasing list decoder
(rtwm/fastpolar.py:59-359) with a dense, static-shape formulation built for
XLA:

* the decode tree is walked by ONE ``lax.scan`` over the N leaf bits;
* the L list paths live on a batch axis -- path forking/pruning is a single
  ``lax.top_k`` over 2L candidate metrics followed by gathers along that
  axis (no copy-on-write trees, no clone budgets);
* per-level alpha (LLR) and beta (partial-sum) buffers are fixed-size arrays
  in the scan carry; the level-recompute schedule is a pure function of the
  leaf index, so every branch is a *scalar*-predicate ``lax.cond`` that XLA
  executes one-sided -- total work is the optimal O(N log N) per path, not
  O(N^2);
* frames/streams batch on a leading axis, so thousands of decodes run as one
  device program.

Numerics match the reference: exact (logaddexp) f/g combines with the
"positive LLR => bit 1" convention (fastpolar.py:18-29) and the exact
path-metric penalty ``log1p(exp(-|llr|)) (+ |llr| if decision disagrees)``
(fastpolar.py:32-40).  Tie-breaking in the path sort follows the reference's
stable candidate ordering (path index, then bit value).
"""
from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from echoseal_tpu.ops.polar import PolarSpec, crc8_check_batch

BIG_METRIC = 1e30
# Library defaults for ``scl_decode``, one for every backend (measured on
# the GPU; see ``scl_decode``).  ``ECHOSEAL_SCL_IMPL`` and
# ``ECHOSEAL_SCL_DEEP_SEG`` override them.
DEFAULT_IMPL = "blocked"
DEFAULT_DEEP_SEG = 16


def _f_combine(a, b):
    """Exact LLR f-combine: llr of u_left given (a, b)."""
    return jnp.logaddexp(a, b) - jnp.logaddexp(0.0, a + b)


def _g_combine(a, b, u_left):
    """Exact LLR g-combine given the left partial sum."""
    return b + (1.0 - 2.0 * u_left.astype(a.dtype)) * a


def _penalties(leaf_llr):
    """(pen_bit0, pen_bit1) path-metric penalties for a leaf LLR."""
    mag = jnp.abs(leaf_llr)
    soft = jnp.log1p(jnp.exp(-mag))
    pen0 = soft + jnp.where(leaf_llr >= 0.0, mag, 0.0)
    pen1 = soft + jnp.where(leaf_llr >= 0.0, 0.0, mag)
    return pen0, pen1


def _f_combine_ms(a, b):
    """Min-sum f-combine (serving mode): -sign(a)sign(b)min(|a|,|b|).

    The hardware-decoder approximation of the exact logaddexp form --
    no transcendentals, exact when one magnitude dominates.  NOTE the
    leading minus: this repo's LLR convention is ``positive favours
    bit 1`` (log p1/p0), under which the exact ``_f_combine`` satisfies
    f(4, 4) ~ -3.3 -- two confident ones XOR to a confident zero -- so
    the textbook (log p0/p1) min-sum picks up a sign flip.  Non-parity
    by design; FER-validated against the exact decoder on the operating
    envelope (benchmarks/scl_sweep.py ``serving`` section).
    """
    return -jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))


def _penalties_hard(leaf_llr):
    """Hard-decision path-metric penalties (serving mode).

    Drops the softplus term of ``_penalties``: a decision agreeing with
    the LLR sign is free, a disagreement costs |llr| -- the metric used
    by hardware SCL decoders, and the one under which the fast rate-1 /
    SPC node shortcuts below are exact (Hashemi et al., "Fast and
    Flexible Successive-Cancellation List Decoders", IEEE TSP 2017).
    """
    mag = jnp.abs(leaf_llr)
    pen0 = jnp.where(leaf_llr >= 0.0, mag, 0.0)
    pen1 = jnp.where(leaf_llr >= 0.0, 0.0, mag)
    return pen0, pen1


def _gf2_transform(beta: jnp.ndarray) -> jnp.ndarray:
    """Involutive polar kernel over GF(2) on the last axis (static width).

    The decoder's beta-combine is ``parent = [bl ^ br, br]``; the map
    from a subtree's codeword (beta) back to its leaf bits (u) is that
    same transform applied top-down (it is an involution), so rate-1 /
    SPC node shortcuts can emit u for the whole span without walking
    the leaves.
    """
    seg = beta.shape[-1]
    if seg == 1:
        return beta
    h = seg // 2
    p, q = beta[..., :h], beta[..., h:]
    return jnp.concatenate([_gf2_transform(p ^ q), _gf2_transform(q)], -1)


def _gather_paths(tree, parent):
    """Gather every per-path array in ``tree`` along the list axis (axis 1)."""

    def gather(arr):
        idx = parent.reshape(parent.shape + (1,) * (arr.ndim - 2))
        return jnp.take_along_axis(arr, idx.astype(jnp.int32), axis=1)

    return jax.tree_util.tree_map(gather, tree)


@partial(jax.jit, static_argnames=("spec", "list_size"))
def _scl_decode_dense(llr: jnp.ndarray, spec: PolarSpec, list_size: int):
    """Dense-state reference formulation (kept as the parity oracle for
    ``scl_decode``; eagerly gathers full per-path state on every fork).

    Args:
      llr: (B, N) float32, positive favours bit 1.
      spec: static code structure.
      list_size: number of surviving paths L.

    Returns dict with paths sorted by ascending metric along axis 1:
      info_bits: (B, L, info_len) int32
      crc_ok:    (B, L) bool
      metrics:   (B, L) float32
    """
    N, n, L = spec.N, spec.n_stages, int(list_size)
    llr = llr.astype(jnp.float32)
    B = llr.shape[0]
    root = llr[:, None, :]  # (B, 1, N) -- shared by all paths until forking

    frozen = jnp.asarray(spec.frozen)

    alphas = tuple(
        jnp.zeros((B, L, N >> l), jnp.float32) for l in range(1, n + 1)
    )
    betas = tuple(
        jnp.zeros((B, L, 2, N >> l), jnp.int32) for l in range(1, n + 1)
    )
    u = jnp.zeros((B, L, N), jnp.int32)
    metric = jnp.concatenate(
        [jnp.zeros((B, 1)), jnp.full((B, L - 1), BIG_METRIC)], axis=1
    ).astype(jnp.float32) if L > 1 else jnp.zeros((B, 1), jnp.float32)

    def body(carry, phi):
        alphas, betas, u, metric = carry
        alphas = list(alphas)
        betas = list(betas)

        # ---- 1) recompute alphas down the active path -------------------
        for l in range(1, n + 1):
            seg = N >> l
            need = (phi & ((1 << (n - l)) - 1)) == 0
            phi_l = phi >> (n - l)
            parent = root if l == 1 else alphas[l - 2]
            left, right = parent[..., :seg], parent[..., seg:]
            beta_left = betas[l - 1][:, :, 0, :]

            def recompute(left=left, right=right, beta_left=beta_left,
                          phi_l=phi_l, l=l):
                g_val = lambda: _g_combine(left, right, beta_left)
                f_val = lambda: jnp.broadcast_to(
                    _f_combine(left, right), (B, L, left.shape[-1])
                )
                return jax.lax.cond((phi_l & 1) == 1, g_val, f_val)

            alphas[l - 1] = jax.lax.cond(
                need, recompute, lambda a=alphas[l - 1]: a
            )

        leaf = alphas[n - 1][..., 0]  # (B, L)
        pen0, pen1 = _penalties(leaf)

        # ---- 2) leaf decision -------------------------------------------
        def frozen_branch(alphas, betas, u, metric):
            return alphas, betas, u, metric + pen0, jnp.zeros((B, L), jnp.int32)

        def info_branch(alphas, betas, u, metric):
            cand = jnp.stack([metric + pen0, metric + pen1], axis=-1)
            cand = cand.reshape(B, 2 * L)  # ordered (path0,b0),(path0,b1),...
            neg_vals, idx = jax.lax.top_k(-cand, L)
            parent = idx >> 1
            bits = (idx & 1).astype(jnp.int32)
            tree = (alphas, betas, u)
            g_alphas, g_betas, g_u = _gather_paths(tree, parent)
            return g_alphas, g_betas, g_u, -neg_vals, bits

        alphas, betas, u, metric, bits = jax.lax.cond(
            frozen[phi],
            frozen_branch,
            info_branch,
            tuple(alphas), tuple(betas), u, metric,
        )
        alphas = list(alphas)
        betas = list(betas)

        # ---- 3) record the decision -------------------------------------
        u = jax.lax.dynamic_update_slice(u, bits[:, :, None], (0, 0, phi))
        betas[n - 1] = jax.lax.dynamic_update_slice(
            betas[n - 1], bits[:, :, None, None], (0, 0, phi & 1, 0)
        )

        # ---- 4) propagate partial sums up completed subtrees -------------
        for l in range(n, 1, -1):
            span = 1 << (n - l + 1)
            prop = ((phi + 1) & (span - 1)) == 0
            slot = (phi >> (n - l + 1)) & 1

            def combine(bl=betas[l - 1], bp=betas[l - 2], slot=slot):
                left, right = bl[:, :, 0, :], bl[:, :, 1, :]
                seg = jnp.concatenate(
                    [jnp.bitwise_xor(left, right), right], axis=-1
                )
                return jax.lax.dynamic_update_slice(
                    bp, seg[:, :, None, :], (0, 0, slot, 0)
                )

            betas[l - 2] = jax.lax.cond(
                prop, combine, lambda b=betas[l - 2]: b
            )

        return (tuple(alphas), tuple(betas), u, metric), None

    (alphas, betas, u, metric), _ = jax.lax.scan(
        body, (alphas, betas, u, metric), jnp.arange(N, dtype=jnp.int32)
    )

    data = u[..., jnp.asarray(spec.data_pos)]
    info = data[..., : spec.info_len]
    crc = data[..., spec.info_len:]
    crc_ok = crc8_check_batch(info, crc, spec.crc_mat)

    order = jnp.argsort(metric, axis=-1, stable=True)
    info = jnp.take_along_axis(info, order[..., None], axis=1)
    crc_ok = jnp.take_along_axis(crc_ok, order, axis=1)
    metric = jnp.take_along_axis(metric, order, axis=1)
    return {"info_bits": info, "crc_ok": crc_ok, "metrics": metric}


def _take_rows(arr: jnp.ndarray, src: jnp.ndarray) -> jnp.ndarray:
    """Gather path rows: arr (B, L, ...) indexed by src (B, L) on axis 1."""
    idx = src.reshape(src.shape + (1,) * (arr.ndim - 2)).astype(jnp.int32)
    return jnp.take_along_axis(arr, idx, axis=1)


def scl_decode(llr: jnp.ndarray, spec: PolarSpec, list_size: int):
    """List-decode a batch of LLR vectors (backend-dispatched).

    Production formulations (identical results, measured parity tests in
    tests/test_scl_proof.py):

    * ``_scl_decode_unrolled`` -- statically-unrolled fast-list decode:
      frozen leaves skip the fork machinery, aligned rate-0 / repetition
      subtrees collapse to exact node-level shortcuts.  Large program,
      slow to compile.
    * ``_scl_decode_lazy`` -- flat scan with per-level source index maps
      and a dense deep tier of width ``DEFAULT_DEEP_SEG``; the
      compile-cheap choice.
    * ``_scl_decode_blocked`` -- two-level scan (cold shallow buffers
      leave the inner loop).

    ``DEFAULT_IMPL`` is ``blocked``, chosen by timing all three on an
    H100: at L=8/B=256 it decoded ~9x the lazy scan's rate with a
    cold compile of seconds, where ``unrolled`` decoded ~6x faster
    still but took minutes to compile per shape.  Override with ECHOSEAL_SCL_IMPL in {"serving", "unrolled",
    "blocked", "lazy", "dense"}; any other value raises (a typo must not
    silently run a slower formulation).  "serving" is the non-parity
    fast-SSCL mode (see ``scl_decode_serving``).

    Args:
      llr: (B, N) float32, positive favours bit 1.
      spec: static code structure.
      list_size: number of surviving paths L.

    Returns dict with paths sorted by ascending metric along axis 1:
      info_bits: (B, L, info_len) int32
      crc_ok:    (B, L) bool
      metrics:   (B, L) float32
    """
    impl = os.environ.get("ECHOSEAL_SCL_IMPL", DEFAULT_IMPL)
    if impl == "serving":
        block_seg = int(os.environ.get("ECHOSEAL_SCL_BLOCK_SEG", 16))
        return _scl_decode_unrolled(llr, spec, int(list_size), block_seg,
                                    serving=True)
    if impl == "unrolled":
        block_seg = int(os.environ.get("ECHOSEAL_SCL_BLOCK_SEG", 16))
        return _scl_decode_unrolled(llr, spec, int(list_size), block_seg)
    if impl == "blocked":
        block_seg = int(os.environ.get("ECHOSEAL_SCL_BLOCK_SEG", 16))
        return _scl_decode_blocked(llr, spec, int(list_size), block_seg)
    if impl == "dense":
        return _scl_decode_dense(llr, spec, int(list_size))
    if impl != "lazy":
        raise ValueError(
            f"ECHOSEAL_SCL_IMPL={impl!r}: expected one of "
            "'serving', 'unrolled', 'blocked', 'lazy', 'dense'")
    return _scl_decode_lazy(llr, spec, int(list_size))


def scl_decode_serving(llr: jnp.ndarray, spec: PolarSpec, list_size: int):
    """List decode entry for the BATCH LADDER.

    The fast-SSCL formulation (``_scl_decode_unrolled(serving=True)``:
    min-sum f-combine, hard-decision path metric, rate-1/SPC node forks
    capped at ``min(L-1, .)``) is FER-equivalent to the exact decoders
    across the operating envelope (benchmarks/scl_sweep.py ``serving``
    rows), and its extra per-fork registry state (_fa/_ford/_fflip
    riding every rate-1/SPC fork gather) makes a much larger program to
    compile.  Its GPU throughput is not measured.

    The ladder therefore uses the EXACT decoder by default; the
    fast-SSCL mode stays available: set ``ECHOSEAL_SCL_SERVING=1`` to
    opt in, or
    ``ECHOSEAL_SCL_IMPL`` (which always wins) to force any specific
    implementation everywhere.
    """
    if os.environ.get("ECHOSEAL_SCL_IMPL") is not None:
        return scl_decode(llr, spec, list_size)
    if os.environ.get("ECHOSEAL_SCL_SERVING"):
        block_seg = int(os.environ.get("ECHOSEAL_SCL_BLOCK_SEG", 16))
        return _scl_decode_unrolled(llr, spec, int(list_size), block_seg,
                                    serving=True)
    return scl_decode(llr, spec, list_size)


@partial(jax.jit, static_argnames=("spec", "list_size"))
def _scl_decode_lazy(llr: jnp.ndarray, spec: PolarSpec, list_size: int):
    """List-decode a batch of LLR vectors.

    Args:
      llr: (B, N) float32, positive favours bit 1.
      spec: static code structure.
      list_size: number of surviving paths L.

    Returns dict with paths sorted by ascending metric along axis 1:
      info_bits: (B, L, info_len) int32
      crc_ok:    (B, L) bool
      metrics:   (B, L) float32

    Memory-traffic design (the dense formulation ``_scl_decode_dense``
    gathers EVERY per-path buffer on EVERY fork -- ~0.5 GB per info bit at
    B=128, L=256):

    * Path forks never touch the alpha/beta buffers.  Each level keeps a
      per-path SOURCE INDEX map (B, L); a fork permutes the 2n tiny index
      maps, and a buffer is physically gathered only when its level is
      recomputed/propagated -- which happens on the optimal O(N log N)
      schedule, so total gather traffic drops ~two orders of magnitude.
    * The decision history ``u`` is not carried at all: the scan emits
      (parent, bit) per leaf and a reverse-scan TRACEBACK reconstructs
      every surviving path's bits once at the end (classic SCL traceback).
    * Frozen leaves reuse the fork machinery with the bit-1 penalty masked
      to BIG_METRIC: a single (B, 2L) top_k replaces the traced branch --
      path order within equal metrics differs from the dense version, but
      the surviving path SET and all metrics are identical.
    """
    N, n, L = spec.N, spec.n_stages, int(list_size)
    llr = llr.astype(jnp.float32)
    B = llr.shape[0]
    root = llr[:, None, :]  # (B, 1, N) -- shared by all paths, never forked

    frozen = jnp.asarray(spec.frozen)
    ident = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    slot_ax = jnp.arange(2, dtype=jnp.int32)

    # ---- level partition -------------------------------------------------
    # A gather HLO can cost a FIXED overhead per (B*L) row-operation, so
    # the design minimises the NUMBER of gathers per leaf, not bytes:
    #   * DEEP levels (seg <= 16) -- which recompute/propagate almost every
    #     leaf -- live as small DENSE per-path arrays (da/db) that ride the
    #     single fork gather; their reads/writes are static slices.
    #   * SHALLOW levels (big buffers, rare recompute) keep per-path source
    #     index maps; a fork permutes the maps, and the buffers are only
    #     gathered on their (rare) recompute/propagate events.
    # Everything forkable -- index maps, deep betas, deep alphas (bitcast
    # f32->int32) -- is stacked so a fork is ONE take_along_axis.
    # Deep-tier width: a wide tier (seg <= 16) keeps the frequently
    # touched levels dense, trading fewer gathers for in-scan slice
    # updates, which XLA:CPU does not fuse (a wide tier measured 6x
    # slower there); ``DEFAULT_DEEP_SEG`` is the width measured best on
    # the GPU.
    deep_seg = int(os.environ.get("ECHOSEAL_SCL_DEEP_SEG", DEFAULT_DEEP_SEG))
    ld0 = next((l for l in range(1, n + 1) if (N >> l) <= deep_seg), n)
    ld0 = max(ld0, 2)                       # keep level 1 shallow (root)
    ns = ld0 - 1                            # number of shallow levels
    deep = list(range(ld0, n + 1))
    segs = {l: N >> l for l in deep}
    offs = {}
    A = 0
    for l in deep:
        offs[l] = A
        A += segs[l]
    off_n = offs[n]

    alphas = tuple(
        jnp.zeros((B, L, N >> l), jnp.float32) for l in range(1, ld0)
    )
    betas = tuple(
        jnp.zeros((B, L, 2, N >> l), jnp.int32) for l in range(1, ld0)
    )
    da = jnp.zeros((B, L, A), jnp.float32)
    db = jnp.zeros((B, L, 2, A), jnp.int32)
    # stacked shallow source maps: column l-1 = alpha level l, ns + l-1 =
    # beta level l
    src = jnp.broadcast_to(
        jnp.arange(L, dtype=jnp.int32)[None, :, None], (B, L, 2 * ns))
    metric = jnp.concatenate(
        [jnp.zeros((B, 1)), jnp.full((B, L - 1), BIG_METRIC)], axis=1
    ).astype(jnp.float32) if L > 1 else jnp.zeros((B, 1), jnp.float32)


    def body(carry, phi):
        alphas, betas, da, db, src, metric = carry
        alphas, betas = list(alphas), list(betas)

        # ---- 1) recompute alphas down the active path -------------------
        # (level l refreshes every 2^(n-l) leaves; parents were already
        # refreshed earlier in this loop when needed, so reads see this
        # step's values -- same schedule as the reference's lazy tree)
        for l in range(1, ld0):                       # shallow levels
            seg = N >> l
            need = (phi & ((1 << (n - l)) - 1)) == 0
            phi_l = phi >> (n - l)

            def recompute(l=l, seg=seg, phi_l=phi_l):
                parent = (root if l == 1
                          else _take_rows(alphas[l - 2], src[:, :, l - 2]))
                left, right = parent[..., :seg], parent[..., seg:]
                beta_left = _take_rows(
                    betas[l - 1], src[:, :, ns + l - 1])[:, :, 0, :]
                g_val = lambda: _g_combine(left, right, beta_left)
                f_val = lambda: jnp.broadcast_to(
                    _f_combine(left, right), (B, L, seg))
                return jax.lax.cond((phi_l & 1) == 1, g_val, f_val), ident

            alphas[l - 1], new_col = jax.lax.cond(
                need, recompute,
                lambda a=alphas[l - 1], s=src[:, :, l - 1]: (a, s))
            src = src.at[:, :, l - 1].set(new_col)

        # Deep levels: pure dataflow through per-level seg values, then ONE
        # concatenate -- slice-update ops can carry the same fixed per-op
        # cost as gathers, so da/db are each rebuilt in a single op per
        # step, not one .at per level.
        da_segs: dict[int, jnp.ndarray] = {}
        for l in deep:                                 # dense deep levels
            seg, off = segs[l], offs[l]
            need = (phi & ((1 << (n - l)) - 1)) == 0
            phi_l = phi >> (n - l)
            old = da[:, :, off : off + seg]
            if l == ld0:
                # parent is the deepest SHALLOW level: gather via its map,
                # but only on this level's (1 in 2^(n-ld0)) recompute steps
                def reco(l=l, seg=seg, phi_l=phi_l, off=off):
                    if ld0 == 1:
                        parent = root
                    else:
                        parent = _take_rows(alphas[ld0 - 2],
                                            src[:, :, ld0 - 2])
                    left, right = parent[..., :seg], parent[..., seg:]
                    beta_left = db[:, :, 0, off : off + seg]
                    return jnp.where(
                        (phi_l & 1) == 1,
                        _g_combine(left, right, beta_left),
                        jnp.broadcast_to(_f_combine(left, right),
                                         (B, L, seg)))

                da_segs[l] = jax.lax.cond(need, reco, lambda o=old: o)
            else:
                # parent is the deep level above, freshly threaded
                parent = da_segs[l - 1]
                left, right = parent[..., :seg], parent[..., seg:]
                beta_left = db[:, :, 0, off : off + seg]
                new = jnp.where((phi_l & 1) == 1,
                                _g_combine(left, right, beta_left),
                                _f_combine(left, right))
                da_segs[l] = jnp.where(need, new, old)
        da = jnp.concatenate([da_segs[l] for l in deep], axis=-1)

        leaf = da[:, :, off_n]  # level n refreshes every step
        pen0, pen1 = _penalties(leaf)
        pen1 = jnp.where(frozen[phi], BIG_METRIC, pen1)

        # ---- 2) fork: one top_k + ONE stacked gather ---------------------
        cand = jnp.stack([metric + pen0, metric + pen1], axis=-1)
        cand = cand.reshape(B, 2 * L)  # ordered (path0,b0),(path0,b1),...
        neg_vals, idx = jax.lax.top_k(-cand, L)
        parent = (idx >> 1).astype(jnp.int32)
        bits = (idx & 1).astype(jnp.int32)
        metric = -neg_vals
        stacked = jnp.concatenate(
            [src, db.reshape(B, L, 2 * A),
             jax.lax.bitcast_convert_type(da, jnp.int32)], axis=-1)
        stacked = jnp.take_along_axis(stacked, parent[..., None], axis=1)
        src = stacked[..., : 2 * ns]
        db = stacked[..., 2 * ns : 2 * ns + 2 * A].reshape(B, L, 2, A)
        da = jax.lax.bitcast_convert_type(
            stacked[..., 2 * ns + 2 * A :], jnp.float32)

        # ---- 3+4) record the decision, propagate completed subtrees ------
        # (deep levels threaded as seg values, rebuilt with one concatenate)
        db_segs = {l: db[:, :, :, offs[l] : offs[l] + segs[l]] for l in deep}
        db_segs[n] = jnp.where((slot_ax == (phi & 1))[None, None, :, None],
                               bits[:, :, None, None], db_segs[n])
        for l in range(n, 1, -1):
            span = 1 << (n - l + 1)
            prop = ((phi + 1) & (span - 1)) == 0
            slot = (phi >> (n - l + 1)) & 1

            if l > ld0:
                # deep child -> deep dest: threaded values, no gathers
                child = db_segs[l]
                left, right = child[:, :, 0, :], child[:, :, 1, :]
                seg = jnp.concatenate(
                    [jnp.bitwise_xor(left, right), right], axis=-1)
                old = db_segs[l - 1]
                new = jnp.where((slot_ax == slot)[None, None, :, None],
                                seg[:, :, None, :], old)
                db_segs[l - 1] = jnp.where(prop, new, old)
            elif l == ld0:
                # deep child -> shallow dest (rare: every 2^(n-ld0+1) leaves)
                def combine(slot=slot, l=l):
                    child = db_segs[l]
                    left, right = child[:, :, 0, :], child[:, :, 1, :]
                    seg = jnp.concatenate(
                        [jnp.bitwise_xor(left, right), right], axis=-1)
                    dest = _take_rows(betas[l - 2], src[:, :, ns + l - 2])
                    return jnp.where(
                        (slot_ax == slot)[None, None, :, None],
                        seg[:, :, None, :], dest), ident

                betas[l - 2], new_col = jax.lax.cond(
                    prop, combine,
                    lambda b=betas[l - 2], s=src[:, :, ns + l - 2]: (b, s))
                src = src.at[:, :, ns + l - 2].set(new_col)
            else:
                # shallow child -> shallow dest (rarer still)
                def combine(l=l, slot=slot):
                    child = _take_rows(betas[l - 1], src[:, :, ns + l - 1])
                    left, right = child[:, :, 0, :], child[:, :, 1, :]
                    seg = jnp.concatenate(
                        [jnp.bitwise_xor(left, right), right], axis=-1)
                    dest = _take_rows(betas[l - 2], src[:, :, ns + l - 2])
                    return jnp.where(
                        (slot_ax == slot)[None, None, :, None],
                        seg[:, :, None, :], dest), ident

                betas[l - 2], new_col = jax.lax.cond(
                    prop, combine,
                    lambda b=betas[l - 2], s=src[:, :, ns + l - 2]: (b, s))
                src = src.at[:, :, ns + l - 2].set(new_col)

        db = jnp.concatenate([db_segs[l] for l in deep], axis=-1)

        carry = (tuple(alphas), tuple(betas), da, db, src, metric)
        return carry, (parent, bits)

    (alphas, betas, da, db, src, metric), (parents, bits) = jax.lax.scan(
        body, (alphas, betas, da, db, src, metric),
        jnp.arange(N, dtype=jnp.int32))

    # ---- traceback: reconstruct u for the L survivors --------------------
    def tb(cur, rec):
        parent, b = rec
        out = jnp.take_along_axis(b, cur, axis=1)
        return jnp.take_along_axis(parent, cur, axis=1), out

    _, u_rev = jax.lax.scan(tb, ident, (parents, bits), reverse=True)
    u = jnp.moveaxis(u_rev, 0, -1)  # (B, L, N)

    data = u[..., jnp.asarray(spec.data_pos)]
    info = data[..., : spec.info_len]
    crc = data[..., spec.info_len:]
    crc_ok = crc8_check_batch(info, crc, spec.crc_mat)

    order = jnp.argsort(metric, axis=-1, stable=True)
    info = jnp.take_along_axis(info, order[..., None], axis=1)
    crc_ok = jnp.take_along_axis(crc_ok, order, axis=1)
    metric = jnp.take_along_axis(metric, order, axis=1)
    return {"info_bits": info, "crc_ok": crc_ok, "metrics": metric}


@partial(jax.jit, static_argnames=("spec", "list_size", "block_seg"))
def _scl_decode_blocked(llr: jnp.ndarray, spec: PolarSpec, list_size: int,
                        block_seg: int = 16):
    """Two-level (blocked) SCL formulation.

    Motivation: in the flat scan formulation the scan carry holds every
    shallow alpha/beta buffer (~370 MB at B=128, L=256), and a backend
    that executes a per-leaf ``lax.cond`` over those buffers as a
    select pays a full-buffer copy whether or not the branch is taken.

    Structure: leaves are processed in blocks of ``2^(n-ld0+1)`` (32 for
    the shipped N=1024, seg<=16 deep tier):

    * OUTER ``lax.scan`` over blocks: recomputes the cold shallow alphas
      (levels 1..ld0-2) and the HOT parent alpha (level ld0-1, which
      enters the inner carry), and runs the beta-propagation cascade into
      the cold beta buffers -- all the ``lax.cond``s live here, paying
      their carry copies once per BLOCK instead of once per leaf.
    * INNER ``lax.scan`` over the block's leaves: pure dataflow -- deep
      alpha/beta threading, penalties, the (B, 2L) top_k fork, and ONE
      stacked gather moving {src maps, deep betas, deep alphas, hot
      parent alpha, packed decisions} onto the surviving paths.  No
      conds, no big buffers.

    There is NO traceback: the reverse traceback scan (two (B, L)-row
    gathers x N steps at fixed per-op cost) can cost more than the whole
    forward pass.  Instead the decision history rides the
    fork gather BIT-PACKED -- ``u_packed`` (B, L, N/32) int32, one word
    updated per leaf via a pure ``where`` -- so every path's bits are
    already path-indexed when the scan ends (width +N/32 on a gather
    whose cost is per-row, not per-byte).

    Path bookkeeping (source index maps, frozen-masked fork) matches
    ``_scl_decode_lazy``; results are identical (parity tests).
    """
    N, n, L = spec.N, spec.n_stages, int(list_size)
    llr = llr.astype(jnp.float32)
    B = llr.shape[0]
    root = llr[:, None, :]

    frozen = jnp.asarray(spec.frozen)
    ident = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    slot_ax = jnp.arange(2, dtype=jnp.int32)

    ld0 = next((l for l in range(1, n + 1) if (N >> l) <= block_seg), n)
    ld0 = max(ld0, 2)
    hp = ld0 - 1                   # hot parent level (alpha in inner carry)
    n_blk = 1 << (n - ld0 + 1)     # leaves per block
    n_blocks = N // n_blk

    deep = list(range(ld0, n + 1))
    segs = {l: N >> l for l in deep}
    offs: dict[int, int] = {}
    A = 0
    for l in deep:
        offs[l] = A
        A += segs[l]
    off_n = offs[n]
    seg_hp = N >> hp

    nca = hp - 1                   # cold alpha levels: 1..hp-1
    ncb = hp                       # cold beta levels: 1..hp
    ns_cols = nca + ncb
    cold_alphas = tuple(
        jnp.zeros((B, L, N >> l), jnp.float32) for l in range(1, hp))
    cold_betas = tuple(
        jnp.zeros((B, L, 2, N >> l), jnp.int32) for l in range(1, hp + 1))
    src = jnp.broadcast_to(
        jnp.arange(L, dtype=jnp.int32)[None, :, None], (B, L, ns_cols))
    a_hp = jnp.zeros((B, L, seg_hp), jnp.float32)
    da = jnp.zeros((B, L, A), jnp.float32)
    db = jnp.zeros((B, L, 2, A), jnp.int32)
    n_words = -(-N // 32)
    word_ax = jnp.arange(n_words, dtype=jnp.int32)
    u_packed = jnp.zeros((B, L, n_words), jnp.int32)
    metric = jnp.concatenate(
        [jnp.zeros((B, 1)), jnp.full((B, L - 1), BIG_METRIC)], axis=1
    ).astype(jnp.float32) if L > 1 else jnp.zeros((B, 1), jnp.float32)

    # static per-block rate-0 flags (6/32 blocks for the shipped specs)
    rate0_flags = jnp.asarray(
        np.asarray(spec.frozen).reshape(n_blocks, n_blk).all(axis=1))

    def outer(carry, xs):
        t, is_rate0 = xs
        cold_alphas, cold_betas, src, a_hp, da, db, u_packed, metric = carry
        cold_alphas, cold_betas = list(cold_alphas), list(cold_betas)
        phi0 = t * n_blk

        # ---- block start: cold alpha recomputes + hot parent ------------
        for l in range(1, hp + 1):
            seg = N >> l
            need = (phi0 & ((1 << (n - l)) - 1)) == 0
            phi_l = phi0 >> (n - l)

            def recompute(l=l, seg=seg, phi_l=phi_l,
                          cold_alphas=cold_alphas, src=src):
                parent = (root if l == 1
                          else _take_rows(cold_alphas[l - 2],
                                          src[:, :, l - 2]))
                left, right = parent[..., :seg], parent[..., seg:]
                beta_left = _take_rows(
                    cold_betas[l - 1], src[:, :, nca + l - 1])[:, :, 0, :]
                g_val = lambda: _g_combine(left, right, beta_left)
                f_val = lambda: jnp.broadcast_to(
                    _f_combine(left, right), (B, L, seg))
                return jax.lax.cond((phi_l & 1) == 1, g_val, f_val)

            if l < hp:
                cold_alphas[l - 1], new_col = jax.lax.cond(
                    need, lambda r=recompute: (r(), ident),
                    lambda a=cold_alphas[l - 1], s=src[:, :, l - 1]: (a, s))
                src = src.at[:, :, l - 1].set(new_col)
            else:
                # hot parent: when not recomputed this block, the carried
                # value is already per-path (it rides every fork gather)
                a_hp = jax.lax.cond(need, recompute, lambda v=a_hp: v)

        # ---- inner scan: the block's leaves, pure dataflow ---------------
        def rate0_block(operands):
            """ALL-frozen block: exact metric shortcut, no leaf walk.

            For a rate-0 node the exact path-metric increment equals
            sum_j softplus(alpha_j) over the NODE's alphas (provable by
            induction on f/g: softplus(f(a,b)) + softplus(g(a,b,0)) =
            softplus(a) + softplus(b)) -- and the node alphas ARE the hot
            parent a_hp.  No forks (all paths pick bit 0), so src /
            a_hp / u_packed are untouched; the span's betas are all zero,
            so db is zeroed (the only cross-block db read comes from the
            immediately preceding block, deeper state flows through the
            cold buffers by construction).
            """
            src, a_hp, da, db, u_packed, metric = operands
            metric = metric + jnp.sum(jax.nn.softplus(a_hp), axis=-1)
            return src, a_hp, da, jnp.zeros_like(db), u_packed, metric

        def body(icarry, j):
            src, a_hp, da, db, u_packed, metric = icarry
            phi = phi0 + j

            da_segs: dict[int, jnp.ndarray] = {}
            for l in deep:
                seg, off = segs[l], offs[l]
                need = (phi & ((1 << (n - l)) - 1)) == 0
                phi_l = phi >> (n - l)
                parent = a_hp if l == ld0 else da_segs[l - 1]
                left, right = parent[..., :seg], parent[..., seg:]
                beta_left = db[:, :, 0, off : off + seg]
                new = jnp.where((phi_l & 1) == 1,
                                _g_combine(left, right, beta_left),
                                _f_combine(left, right))
                da_segs[l] = jnp.where(need, new, da[:, :, off : off + seg])
            da = jnp.concatenate([da_segs[l] for l in deep], axis=-1)

            leaf = da[:, :, off_n]
            pen0, pen1 = _penalties(leaf)
            pen1 = jnp.where(frozen[phi], BIG_METRIC, pen1)

            cand = jnp.stack([metric + pen0, metric + pen1], axis=-1)
            cand = cand.reshape(B, 2 * L)
            neg_vals, idx = jax.lax.top_k(-cand, L)
            parent_ix = (idx >> 1).astype(jnp.int32)
            bits = (idx & 1).astype(jnp.int32)
            metric = -neg_vals
            stacked = jnp.concatenate(
                [src, db.reshape(B, L, 2 * A),
                 jax.lax.bitcast_convert_type(da, jnp.int32),
                 jax.lax.bitcast_convert_type(a_hp, jnp.int32),
                 u_packed], axis=-1)
            stacked = jnp.take_along_axis(stacked, parent_ix[..., None],
                                          axis=1)
            src = stacked[..., :ns_cols]
            db = stacked[..., ns_cols : ns_cols + 2 * A].reshape(B, L, 2, A)
            da = jax.lax.bitcast_convert_type(
                stacked[..., ns_cols + 2 * A : ns_cols + 3 * A], jnp.float32)
            a_hp = jax.lax.bitcast_convert_type(
                stacked[..., ns_cols + 3 * A : ns_cols + 3 * A + seg_hp],
                jnp.float32)
            u_packed = stacked[..., ns_cols + 3 * A + seg_hp :]

            # record the decision: one packed word touched, pure dataflow
            u_packed = jnp.where(word_ax == (phi >> 5),
                                 u_packed | (bits[:, :, None] << (phi & 31)),
                                 u_packed)

            db_segs = {l: db[:, :, :, offs[l] : offs[l] + segs[l]]
                       for l in deep}
            db_segs[n] = jnp.where(
                (slot_ax == (phi & 1))[None, None, :, None],
                bits[:, :, None, None], db_segs[n])
            for l in range(n, ld0, -1):       # props into DEEP dests only
                span = 1 << (n - l + 1)
                prop = ((phi + 1) & (span - 1)) == 0
                child = db_segs[l]
                left, right = child[:, :, 0, :], child[:, :, 1, :]
                seg2 = jnp.concatenate(
                    [jnp.bitwise_xor(left, right), right], axis=-1)
                slot = (phi >> (n - l + 1)) & 1
                old = db_segs[l - 1]
                new = jnp.where((slot_ax == slot)[None, None, :, None],
                                seg2[:, :, None, :], old)
                db_segs[l - 1] = jnp.where(prop, new, old)
            db = jnp.concatenate([db_segs[l] for l in deep], axis=-1)

            return (src, a_hp, da, db, u_packed, metric), ()

        def full_block(operands):
            out, _ = jax.lax.scan(body, operands,
                                  jnp.arange(n_blk, dtype=jnp.int32))
            return out

        (src, a_hp, da, db, u_packed, metric) = jax.lax.cond(
            is_rate0, rate0_block, full_block,
            (src, a_hp, da, db, u_packed, metric))

        # ---- block end: level ld0 -> cold beta hp (fires every block) ----
        phi_end = phi0 + n_blk - 1
        child = db[:, :, :, offs[ld0] : offs[ld0] + segs[ld0]]
        left, right = child[:, :, 0, :], child[:, :, 1, :]
        seg2 = jnp.concatenate([jnp.bitwise_xor(left, right), right],
                               axis=-1)
        slot = (phi_end >> (n - ld0 + 1)) & 1
        dest = _take_rows(cold_betas[hp - 1], src[:, :, nca + hp - 1])
        cold_betas[hp - 1] = jnp.where(
            (slot_ax == slot)[None, None, :, None],
            seg2[:, :, None, :], dest)
        src = src.at[:, :, nca + hp - 1].set(ident)

        # cascade into shallower cold betas (rare; conds once per block)
        for l in range(hp, 1, -1):
            span = 1 << (n - l + 1)
            prop = ((phi_end + 1) & (span - 1)) == 0

            def combine(l=l, cold_betas=cold_betas, src=src):
                child = _take_rows(cold_betas[l - 1], src[:, :, nca + l - 1])
                left, right = child[:, :, 0, :], child[:, :, 1, :]
                s2 = jnp.concatenate(
                    [jnp.bitwise_xor(left, right), right], axis=-1)
                dest = _take_rows(cold_betas[l - 2], src[:, :, nca + l - 2])
                slot = (phi_end >> (n - l + 1)) & 1
                return jnp.where((slot_ax == slot)[None, None, :, None],
                                 s2[:, :, None, :], dest), ident

            cold_betas[l - 2], new_col = jax.lax.cond(
                prop, combine,
                lambda b=cold_betas[l - 2], s=src[:, :, nca + l - 2]: (b, s))
            src = src.at[:, :, nca + l - 2].set(new_col)

        carry = (tuple(cold_alphas), tuple(cold_betas), src, a_hp, da, db,
                 u_packed, metric)
        return carry, ()

    init = (cold_alphas, cold_betas, src, a_hp, da, db, u_packed, metric)
    (_, _, _, _, _, _, u_packed, metric), _ = jax.lax.scan(
        outer, init,
        (jnp.arange(n_blocks, dtype=jnp.int32), rate0_flags))

    # unpack the per-path decision words: word w bit b <-> leaf w*32+b
    u = ((u_packed[..., None] >> jnp.arange(32, dtype=jnp.int32)) & 1
         ).astype(jnp.int32).reshape(B, L, n_words * 32)[..., :N]

    data = u[..., jnp.asarray(spec.data_pos)]
    info = data[..., : spec.info_len]
    crc = data[..., spec.info_len:]
    crc_ok = crc8_check_batch(info, crc, spec.crc_mat)

    order = jnp.argsort(metric, axis=-1, stable=True)
    info = jnp.take_along_axis(info, order[..., None], axis=1)
    crc_ok = jnp.take_along_axis(crc_ok, order, axis=1)
    metric = jnp.take_along_axis(metric, order, axis=1)
    return {"info_bits": info, "crc_ok": crc_ok, "metrics": metric}


@partial(jax.jit,
         static_argnames=("spec", "list_size", "block_seg", "serving"))
def _scl_decode_unrolled(llr: jnp.ndarray, spec: PolarSpec, list_size: int,
                         block_seg: int = 16, serving: bool = False):
    """Statically-unrolled fast-list formulation.

    The scan formulations pay the full fork machinery -- a (B, 2L)
    ``top_k`` plus the stacked path gather (fixed per-row cost) -- at
    EVERY leaf, because inside ``lax.scan`` the frozen
    pattern is a traced value.  But the pattern is static: this
    formulation unrolls the whole decode at trace time (the code
    structure is a pure function of ``spec.frozen``), which buys, in
    decreasing order of measured weight:

    * frozen leaves (384 of the 832 walked leaves for the shipped compat
      spec) skip the fork entirely -- their decision is forced, so they
      cost one penalty add, no ``top_k``, no gather;
    * any ALIGNED all-frozen subtree inside a block collapses to the
      exact rate-0 metric shortcut ``metric += sum softplus(alpha)``
      (the scan version could only do this at whole-block granularity);
    * repetition subtrees (all-frozen-but-last; present in the v2
      standard-convention spec) collapse to ONE two-candidate fork with
      the exact node-level penalties ``pen(c) = sum_j [log1p(e^-|a_j|) +
      |a_j| * (c disagrees with sign(a_j))]`` -- the per-leaf penalties
      telescope to exactly this by induction on the f/g pair
      (softplus(f(a,b)) + softplus(+-g(a,b,u)) identities), so list
      contents and metrics are bit-identical to the leaf walk;
    * the lazy-recompute schedule specializes: ``lax.cond``/``where``
      selects disappear, each level computes exactly on its O(N log N)
      schedule.

    Path-state layout follows ``_scl_decode_blocked``: cold shallow
    buffers (levels 1..hp) stay out of the fork via per-path source-index
    maps, and everything hot -- src maps, the hot block-root alpha, the
    live deep alphas/betas of the recursion spine, and the bit-packed
    decision words -- rides each fork as ONE stacked gather.  Here the
    stack is assembled per fork from a trace-time registry dict, so only
    arrays actually live at that point in the walk are moved.

    Replaces reference fastpolar.py:254-359; results identical to the
    other formulations (tests/test_scl_proof.py parity, both specs).

    ``serving=True`` switches to the NON-PARITY throughput mode
    (VERDICT r4 next #4), replacing the reference hot loop at
    rtwm/fastpolar.py:280-330 with the fast-SSCL formulation:

    * min-sum f-combine (``_f_combine_ms``) and the hard-decision path
      metric (``_penalties_hard``) -- no transcendentals anywhere;
    * rate-1 (all-info) subtrees collapse to ``min(L-1, seg)``
      least-reliable-bit forks instead of ``seg`` leaf forks, exact
      under the hard metric (Hashemi et al. 2017, Thm. 1);
    * SPC subtrees (frozen[0] only) collapse to a parity fix plus
      ``min(L-1, seg-1)`` forks, each flip re-toggling the least
      reliable bit to keep the parity constraint (ibid., Thm. 2);
    * rate-0 / repetition shortcuts use the matching hard-metric
      penalties.

    List contents can differ from the parity decoders (different
    metric), so serving mode is ladder-only: FER equivalence across
    the operating envelope is measured in benchmarks/scl_sweep.py
    (``serving`` rows) and every accept stays AEAD-gated downstream.
    """
    N, n, L = spec.N, spec.n_stages, int(list_size)
    llr = llr.astype(jnp.float32)
    B = llr.shape[0]
    root = llr[:, None, :]
    frozen = np.asarray(spec.frozen)
    f_comb = _f_combine_ms if serving else _f_combine
    pens = _penalties_hard if serving else _penalties

    ld0 = next((l for l in range(1, n + 1) if (N >> l) <= block_seg), n)
    ld0 = max(ld0, 2)
    hp = ld0 - 1                   # block-root level (alpha rides forks)
    n_blk = 1 << (n - hp)
    n_blocks = N // n_blk
    nca = hp - 1                   # cold alpha levels 1..hp-1
    ns_cols = nca + hp             # + cold beta levels 1..hp

    ident = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    cold_alphas = [
        jnp.zeros((B, L, N >> l), jnp.float32) for l in range(1, hp)]
    cold_betas = [
        jnp.zeros((B, L, 2, N >> l), jnp.int32) for l in range(1, hp + 1)]
    n_words = -(-N // 32)

    # trace-time registry of per-path state that must ride every fork.
    # dict order is insertion order (stable within a trace); values are
    # (B, L, cols) arrays, f32 entries bitcast for the stacked gather.
    S: dict[str, jnp.ndarray] = {
        "src": jnp.broadcast_to(
            jnp.arange(L, dtype=jnp.int32)[None, :, None], (B, L, ns_cols)),
        "u": jnp.zeros((B, L, n_words), jnp.int32),
    }
    metric0 = jnp.concatenate(
        [jnp.zeros((B, 1)), jnp.full((B, L - 1), BIG_METRIC)], axis=1
    ).astype(jnp.float32) if L > 1 else jnp.zeros((B, 1), jnp.float32)
    S["metric"] = metric0          # handled specially by fork (from top_k)

    def fork(pen0: jnp.ndarray, pen1: jnp.ndarray) -> jnp.ndarray:
        """2L-candidate fork: permutes every live array in ``S``."""
        cand = jnp.stack([S["metric"] + pen0, S["metric"] + pen1],
                         axis=-1).reshape(B, 2 * L)
        neg_vals, idx = jax.lax.top_k(-cand, L)
        parent = (idx >> 1).astype(jnp.int32)
        keys = [k for k in S if k != "metric"]
        parts, splits, isf32 = [], [], []
        for k in keys:
            v = S[k]
            flat = v.reshape(B, L, -1)
            isf32.append(v.dtype == jnp.float32)
            if isf32[-1]:
                flat = jax.lax.bitcast_convert_type(flat, jnp.int32)
            parts.append(flat)
            splits.append(flat.shape[-1])
        stacked = jnp.take_along_axis(
            jnp.concatenate(parts, axis=-1), parent[..., None], axis=1)
        off = 0
        for k, w, f32 in zip(keys, splits, isf32):
            piece = stacked[..., off : off + w]
            if f32:
                piece = jax.lax.bitcast_convert_type(piece, jnp.float32)
            S[k] = piece.reshape(S[k].shape)
            off += w
        S["metric"] = -neg_vals
        return (idx & 1).astype(jnp.int32)

    def set_u_bit(phi: int, bits: jnp.ndarray) -> None:
        w, sh = phi >> 5, phi & 31
        S["u"] = S["u"].at[:, :, w].set(S["u"][:, :, w] | (bits << sh))

    def set_u_span(pos: int, bits: jnp.ndarray) -> None:
        """OR a whole aligned span of u bits into the packed words.

        ``pos`` is span-aligned (subtree start), so a span >= 32 covers
        whole words and a span < 32 stays inside one word; packing is
        LSB-first to match ``set_u_bit`` and the final unpack.
        """
        span = bits.shape[-1]
        if span >= 32:
            sh = jnp.arange(32, dtype=jnp.int32)
            words = jnp.sum(bits.reshape(B, L, span // 32, 32) << sh,
                            axis=-1).astype(jnp.int32)
            w0 = pos // 32
            old = jax.lax.dynamic_slice(
                S["u"], (0, 0, w0), (B, L, span // 32))
            S["u"] = jax.lax.dynamic_update_slice(
                S["u"], old | words, (0, 0, w0))
        else:
            sh = jnp.arange(span, dtype=jnp.int32) + (pos & 31)
            word = jnp.sum(bits << sh, axis=-1).astype(jnp.int32)
            w0 = pos >> 5
            S["u"] = S["u"].at[:, :, w0].set(S["u"][:, :, w0] | word)

    def walk(l: int, pos: int, akey: str) -> str:
        """Decode the subtree at level ``l`` starting at leaf ``pos``.

        The subtree root alpha lives in ``S[akey]`` (so forks inside the
        subtree keep it consistent); returns the registry key of the
        (B, L, N>>l) int32 beta.  ``akey`` is consumed (popped).
        """
        seg = N >> l
        span = seg                   # leaves under this node
        fr = frozen[pos : pos + span]
        bkey = f"b{l}_{pos}"
        if fr.all():                 # exact rate-0 shortcut
            a = S.pop(akey)
            pen = (jnp.maximum(a, 0.0) if serving
                   else jax.nn.softplus(a))
            S["metric"] = S["metric"] + jnp.sum(pen, axis=-1)
            S[bkey] = jnp.zeros((B, L, seg), jnp.int32)
            return bkey
        if l == n:                   # single info leaf
            a = S.pop(akey)[..., 0]
            pen0, pen1 = pens(a)
            bits = fork(pen0, pen1)
            set_u_bit(pos, bits)
            S[bkey] = bits[:, :, None]
            return bkey
        if fr[:-1].all() and not fr[-1]:   # exact repetition shortcut
            a = S.pop(akey)
            mag = jnp.abs(a)
            if serving:
                pen_c0 = jnp.sum(jnp.maximum(a, 0.0), axis=-1)
                pen_c1 = jnp.sum(jnp.maximum(-a, 0.0), axis=-1)
            else:
                soft = jnp.log1p(jnp.exp(-mag))
                pen_c0 = jnp.sum(
                    soft + jnp.where(a >= 0.0, mag, 0.0), axis=-1)
                pen_c1 = jnp.sum(
                    soft + jnp.where(a >= 0.0, 0.0, mag), axis=-1)
            bits = fork(pen_c0, pen_c1)
            set_u_bit(pos + span - 1, bits)
            S[bkey] = jnp.broadcast_to(bits[:, :, None], (B, L, seg))
            return bkey
        if serving and not fr.any():       # fast rate-1 node (serving)
            # hard decisions cost 0 under the hard metric; only the
            # min(L-1, seg) least-reliable bits can profitably flip
            # (Hashemi Thm. 1), each flip one standard 2L fork.  The
            # alpha / sort order / flip mask ride the forks via the
            # registry so later steps see the permuted rows.
            a = S.pop(akey)
            if L > 1:
                q = min(L - 1, seg)
                S["_fa"] = a
                S["_ford"] = jnp.argsort(
                    jnp.abs(a), axis=-1)[..., :q].astype(jnp.int32)
                S["_fflip"] = jnp.zeros((B, L, seg), jnp.int32)
                zero_pen = jnp.zeros((B, L), jnp.float32)
                pos_ids = jnp.arange(seg, dtype=jnp.int32)
                for t in range(q):
                    at = jnp.take_along_axis(
                        jnp.abs(S["_fa"]), S["_ford"][..., t : t + 1],
                        -1)[..., 0]
                    flips = fork(zero_pen, at)
                    oh = (pos_ids == S["_ford"][..., t : t + 1]
                          ).astype(jnp.int32)
                    S["_fflip"] = S["_fflip"] ^ (flips[..., None] * oh)
                a = S.pop("_fa")
                flip = S.pop("_fflip")
                del S["_ford"]
                beta = (a > 0.0).astype(jnp.int32) ^ flip
            else:
                beta = (a > 0.0).astype(jnp.int32)
            set_u_span(pos, _gf2_transform(beta))
            S[bkey] = beta
            return bkey
        if serving and fr[0] and not fr[1:].any():  # fast SPC node
            # single-parity-check: fix parity by flipping the least
            # reliable bit, then min(L-1, seg-1) forks, each flip
            # re-toggling that bit to hold the constraint (Hashemi
            # Thm. 2).  pen_flip = |a_t| + (1-2*f0)|a_0| >= 0 because
            # the order is sorted ascending.
            a = S.pop(akey)
            aa = jnp.abs(a)
            hard = (a > 0.0).astype(jnp.int32)
            par = (jnp.sum(hard, axis=-1) & 1)            # (B, L)
            q = min(L - 1, seg - 1) if L > 1 else 0
            order = jnp.argsort(aa, axis=-1)[..., : q + 1].astype(
                jnp.int32)
            a0 = jnp.take_along_axis(aa, order[..., :1], -1)[..., 0]
            S["metric"] = S["metric"] + par.astype(jnp.float32) * a0
            pos_ids = jnp.arange(seg, dtype=jnp.int32)
            oh0 = (pos_ids == order[..., :1]).astype(jnp.int32)
            flip = par[..., None] * oh0
            if q > 0:
                S["_fa"] = a
                S["_ford"] = order
                S["_fflip"] = flip
                S["_ff0"] = par[..., None]                # (B, L, 1)
                zero_pen = jnp.zeros((B, L), jnp.float32)
                for t in range(1, q + 1):
                    aa_c = jnp.abs(S["_fa"])
                    at = jnp.take_along_axis(
                        aa_c, S["_ford"][..., t : t + 1], -1)[..., 0]
                    a0c = jnp.take_along_axis(
                        aa_c, S["_ford"][..., :1], -1)[..., 0]
                    f0 = S["_ff0"][..., 0].astype(jnp.float32)
                    flips = fork(zero_pen, at + (1.0 - 2.0 * f0) * a0c)
                    oht = (pos_ids == S["_ford"][..., t : t + 1]
                           ).astype(jnp.int32)
                    oh0c = (pos_ids == S["_ford"][..., :1]
                            ).astype(jnp.int32)
                    S["_fflip"] = S["_fflip"] ^ (
                        flips[..., None] * (oht ^ oh0c))
                    S["_ff0"] = S["_ff0"] ^ flips[..., None]
                a = S.pop("_fa")
                flip = S.pop("_fflip")
                del S["_ford"], S["_ff0"]
                hard = (a > 0.0).astype(jnp.int32)
            beta = hard ^ flip
            set_u_span(pos, _gf2_transform(beta))
            S[bkey] = beta
            return bkey
        # internal node: f -> left, g -> right, combine betas
        h = seg >> 1
        a = S[akey]
        lkey = f"a{l + 1}_{pos}"
        S[lkey] = f_comb(a[..., :h], a[..., h:])
        blkey = walk(l + 1, pos, lkey)
        a = S.pop(akey)              # re-read: forks may have permuted it
        rkey = f"a{l + 1}_{pos + h}"
        S[rkey] = _g_combine(a[..., :h], a[..., h:], S[blkey])
        brkey = walk(l + 1, pos + h, rkey)
        bl, br = S.pop(blkey), S.pop(brkey)
        S[bkey] = jnp.concatenate([jnp.bitwise_xor(bl, br), br], axis=-1)
        return bkey

    for t in range(n_blocks):
        phi0 = t * n_blk
        # ---- cold alpha recomputes + the block-root (hot) alpha ---------
        for l in range(1, hp + 1):
            seg = N >> l
            if phi0 & ((1 << (n - l)) - 1):
                continue             # level not refreshed at this block
            phi_l = phi0 >> (n - l)
            parent = (root if l == 1
                      else _take_rows(cold_alphas[l - 2],
                                      S["src"][:, :, l - 2]))
            left, right = parent[..., :seg], parent[..., seg:]
            if phi_l & 1:
                beta_left = _take_rows(
                    cold_betas[l - 1], S["src"][:, :, nca + l - 1])[:, :, 0, :]
                val = _g_combine(left, right, beta_left)
            else:
                val = jnp.broadcast_to(
                    f_comb(left, right), (B, L, seg))
            if l < hp:
                cold_alphas[l - 1] = val
                S["src"] = S["src"].at[:, :, l - 1].set(ident)
            else:
                S["ahp"] = val

        # ---- decode the block subtree -----------------------------------
        bkey = walk(hp, phi0, "ahp")
        beta_blk = S.pop(bkey)

        # ---- propagate the block beta into the cold buffers -------------
        phi_end = phi0 + n_blk - 1
        slot = (phi_end >> (n - hp)) & 1
        dest = _take_rows(cold_betas[hp - 1], S["src"][:, :, nca + hp - 1])
        cold_betas[hp - 1] = dest.at[:, :, slot, :].set(beta_blk)
        S["src"] = S["src"].at[:, :, nca + hp - 1].set(ident)
        for l in range(hp, 1, -1):
            if (phi_end + 1) & ((1 << (n - l + 1)) - 1):
                break                # shallower levels complete even later
            child = _take_rows(cold_betas[l - 1], S["src"][:, :, nca + l - 1])
            left, right = child[:, :, 0, :], child[:, :, 1, :]
            seg2 = jnp.concatenate(
                [jnp.bitwise_xor(left, right), right], axis=-1)
            slot = (phi_end >> (n - l + 1)) & 1
            dest = _take_rows(cold_betas[l - 2], S["src"][:, :, nca + l - 2])
            cold_betas[l - 2] = dest.at[:, :, slot, :].set(seg2)
            S["src"] = S["src"].at[:, :, nca + l - 2].set(ident)

    metric = S["metric"]
    u = ((S["u"][..., None] >> jnp.arange(32, dtype=jnp.int32)) & 1
         ).astype(jnp.int32).reshape(B, L, n_words * 32)[..., :N]

    data = u[..., jnp.asarray(spec.data_pos)]
    info = data[..., : spec.info_len]
    crc = data[..., spec.info_len:]
    crc_ok = crc8_check_batch(info, crc, spec.crc_mat)

    order = jnp.argsort(metric, axis=-1, stable=True)
    info = jnp.take_along_axis(info, order[..., None], axis=1)
    crc_ok = jnp.take_along_axis(crc_ok, order, axis=1)
    metric = jnp.take_along_axis(metric, order, axis=1)
    return {"info_bits": info, "crc_ok": crc_ok, "metrics": metric}


def scl_decode_np(llr: np.ndarray, spec: PolarSpec, list_size: int):
    """Convenience host entry: accepts (N,) or (B, N) numpy LLRs."""
    arr = np.asarray(llr, dtype=np.float32)
    squeeze = arr.ndim == 1
    if squeeze:
        arr = arr[None]
    out = scl_decode(jnp.asarray(arr), spec, list_size)
    res = {k: np.asarray(v) for k, v in out.items()}
    if squeeze:
        res = {k: v[0] for k, v in res.items()}
    return res
