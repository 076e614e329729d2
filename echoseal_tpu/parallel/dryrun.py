"""Multi-device dry run: full sharded TX -> RX loop with strict asserts.

``python -m echoseal_tpu.parallel.dryrun N`` runs it on N virtual CPU
devices in a FRESH interpreter (the ``__main__`` block pins the CPU
backend before any JAX backend initialisation);
``__graft_entry__.dryrun_multichip`` launches it that way in a scrubbed
subprocess.  ``chip_smoke.py --four`` calls ``run(4)`` on four real GPUs.

What it proves (reference has no distributed code -- SURVEY.md section 5.8;
this models the scale-out tier the rebuild adds):

* sharded TX: batched frame synthesis ``shard_map``-ed over an N-device
  ``streams`` mesh, output shape- and content-checked;
* sharded RX: the full batched verify program over the same mesh, with the
  ``psum`` verdict reduction across devices (NVLink between GPUs);
* STRICT per-clip verdicts: every one of the N clips must AEAD-verify
  (``finish_host`` all True) -- not a vacuous count check.
"""
from __future__ import annotations

import numpy as np

FRAMES_PER_CLIP = 6


def run(n_devices: int) -> dict:
    """Execute the sharded TX->RX loop; raises AssertionError on any gap.

    Returns the sharded verify inputs and verdicts (``{"nonce", "compat":
    {"inputs", "verdicts"}, "v2": {...}}``) so a caller can re-verify the
    same clips on one device.
    """
    import jax
    import jax.numpy as jnp

    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices, (
        f"need {n_devices} devices, have {len(jax.devices())}"
    )

    from echoseal_tpu.core.params import FRAME_LEN
    from echoseal_tpu.core.sequences import header_bits_batch
    from echoseal_tpu.models.embedder import BatchEmbedder, db_to_lin
    from echoseal_tpu.models.pipeline import BatchVerifier
    from echoseal_tpu.parallel.mesh import shard_tx, shard_verify, streams_mesh
    from echoseal_tpu.core.params import HDR_L, PRE_L
    from echoseal_tpu.core.sequences import bits_to_bpsk, mls63
    from echoseal_tpu.ops import filters

    key = bytes.fromhex("aa" * 32)
    mesh = streams_mesh(devices)
    nonce = b"dryrun!!"

    # ---- sharded TX: FRAMES_PER_CLIP frames per device ------------------
    be = BatchEmbedder(key)
    ctrs = np.arange(n_devices * FRAMES_PER_CLIP, dtype=np.int64)
    info = np.stack([
        np.unpackbits(np.frombuffer(
            be.sec.seal(b"ESAL" + int(c).to_bytes(4, "big") + nonce
                        + bytes(11)), dtype=np.uint8))
        for c in ctrs
    ])
    hdr = header_bits_batch(ctrs)
    pn = be.sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]
    sos = filters.all_band_sos(48_000)[be._hop.indices(ctrs)]
    tx_fn = shard_tx(mesh)
    frames = tx_fn(
        jnp.asarray(info), jnp.asarray(hdr), jnp.asarray(pn),
        jnp.asarray(bits_to_bpsk(be.sec.pn_bits(0, HDR_L))),
        jnp.asarray(bits_to_bpsk(mls63())), jnp.asarray(sos))
    frames.block_until_ready()
    frames_np = np.asarray(frames)
    assert frames_np.shape == (len(ctrs), FRAME_LEN), frames_np.shape
    assert np.all(np.isfinite(frames_np)), "TX produced non-finite chips"
    assert np.all(np.ptp(frames_np, axis=-1) > 0), "TX produced silent frames"

    # cross-check the sharded TX against the unsharded device program
    ref_frames = be.frames(ctrs[:FRAMES_PER_CLIP], session_nonce=nonce)
    # payload randomness differs (fresh seal), but the deterministic
    # preamble region must match exactly between sharded and local TX
    np.testing.assert_allclose(
        frames_np[:FRAMES_PER_CLIP, :63], ref_frames[:, :63],
        rtol=1e-5, atol=1e-6)

    # ---- sharded RX verify: one clip per device --------------------------
    T = 1 << 13  # tiny shapes for the dry run (8192 > 6 frames = 7290)
    scale = db_to_lin(be.p.floor_rel_dbfs)
    clips = np.zeros((n_devices, T), dtype=np.float32)
    stream = frames_np.reshape(n_devices, FRAMES_PER_CLIP * FRAME_LEN)
    clips[:, : stream.shape[1]] = stream * scale
    n_valid = np.full(n_devices, T, dtype=np.int32)

    bv = BatchVerifier(key, max_ctr=64)
    run_fn = shard_verify(bv, mesh)
    out = run_fn(jnp.asarray(clips), jnp.asarray(n_valid))
    jax.block_until_ready(out)

    assert out["crc_ok"].shape[0] == n_devices
    assert len(out["crc_ok"].sharding.device_set) == n_devices, (
        "verify outputs are not spread over the mesh")
    n_crc_ok = int(out["n_crc_ok"])
    assert n_crc_ok >= n_devices, (
        f"psum-reduced CRC pass count {n_crc_ok} < {n_devices} clips"
    )
    verdicts = bv.finish_host(out, expected_nonce=nonce)
    assert verdicts.shape == (n_devices,)
    failed = np.flatnonzero(~verdicts)
    assert failed.size == 0, (
        f"clips {failed.tolist()} failed AEAD verification "
        f"(per-clip ok={np.asarray(out['ok']).tolist()})"
    )

    # wrong-nonce replay must NOT verify (anti-replay policy end-to-end)
    replay = bv.finish_host(out, expected_nonce=b"someone!")
    assert not replay.any(), "anti-replay nonce check accepted a replay"

    # ---- sharded v2 (robust-profile) verify: the flagship tier -----------
    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.parallel.mesh import shard_verify_v2

    tx2 = RobustEmbedder(key)
    tx2._session_nonce = nonce
    span = tx2.profile.span
    T2 = 1 << 15                                  # 3 v2 frames = 29160
    stream2 = tx2.process(np.zeros((3 + n_devices) * span, dtype=np.float32))
    # one clip per device, each cut at a DIFFERENT frame counter so the
    # header-based absolute resolution is exercised shard-locally
    clips2 = np.zeros((n_devices, T2), dtype=np.float32)
    for d in range(n_devices):
        clips2[d] = stream2[d * span: d * span + T2]
    nv2 = np.full(n_devices, T2, dtype=np.int32)

    bv2 = RobustBatchVerifier(key, max_ctr=64)
    run2 = shard_verify_v2(bv2, mesh)
    out2 = run2(jnp.asarray(clips2), jnp.asarray(nv2))
    jax.block_until_ready(out2)

    assert out2["host_packed"].shape == (n_devices, 65), (
        "v2 packed host row must carry the evidence bytes")
    n_crc2 = int(out2["n_crc_ok"])
    assert n_crc2 >= n_devices, (
        f"v2 psum-reduced CRC pass count {n_crc2} < {n_devices} clips")
    # STRICT per-clip verdicts through the FULL host escalation ladder
    # (futility gate -> staged SCL -> extended counters) on the sharded
    # outputs, with the session nonce enforced per clip
    v2_verdicts = bv2._finish_ladder(out2, nonce, True, 1 << 20)
    failed2 = np.flatnonzero(~v2_verdicts)
    assert failed2.size == 0, (
        f"v2 clips {failed2.tolist()} failed AEAD verification "
        f"(per-clip ok={np.asarray(out2['ok']).tolist()})"
    )
    replay2 = bv2._finish_ladder(out2, b"someone!", False, 1 << 20)
    assert not replay2.any(), "v2 anti-replay accepted a wrong session nonce"

    # ---- sharded RECOVERY: the time-scale ladder's device stages ---------
    # (VERDICT r4 next #7) scan -> resample -> re-verify, all shard_map-ed
    # over the same streams mesh; one clip per device, every clip played
    # +3.1% fast, every clip must come back through the sharded loop.
    from echoseal_tpu.models.robust import SCALE_SCAN_GRID
    from echoseal_tpu.parallel.mesh import shard_resample_v2, shard_scan_v2
    from echoseal_tpu.utils import channels

    true_s = 1.031
    clips3 = np.zeros((n_devices, T2), dtype=np.float32)
    nv3 = np.zeros(n_devices, dtype=np.int32)
    for d in range(n_devices):
        y = channels.time_scale(stream2[d * span: d * span + T2].copy(),
                                true_s)
        L = min(y.size, T2)
        clips3[d, :L] = y[:L]
        nv3[d] = L
    out3 = run2(jnp.asarray(clips3), jnp.asarray(nv3))
    v3 = bv2._finish_ladder(out3, nonce, True, 1 << 20)

    scan_fn = shard_scan_v2(bv2, mesh)
    scores = np.asarray(scan_fn(jnp.asarray(clips3), jnp.asarray(nv3)))
    per = scores.reshape(n_devices, len(SCALE_SCAN_GRID), 4).max(axis=2)
    f = np.asarray(SCALE_SCAN_GRID)[np.argmax(per, axis=1)]
    f_med = float(np.median(f))
    assert abs(f_med * true_s - 1.0) < 4e-3, (
        f"sharded scan argmaxed {f_med}, want ~{1.0 / true_s:.5f}")

    # per-clip correction factors (identity argmaxes fall back to the
    # batch median), then up to 3 sharded retry rounds stepping across
    # the scan pick's retry-lattice NEIGHBOURS.  3-frame dry-run clips
    # carry too few sync peaks for the serving ladder's inter-peak
    # refinement (+-2-sample jitter over a ~2-frame baseline is ~2e-4
    # of ratio noise, larger than the sub-lattice residual being
    # estimated), so the bracket [k, k-1, k+1] is the deterministic
    # equivalent: the grid step is ~40 lattice steps wide, so the true
    # rational is always within one step of the scan pick.
    res_fn = shard_resample_v2(bv2, mesh, T2)
    factors = np.where(np.abs(f - 1.0) <= 1e-4, f_med, f)
    k_scan = np.round(bv2.RETRY_UP * factors).astype(np.int64)
    recovered = v3.copy()
    for step in (0, -1, +1):
        dens: dict[int, list[int]] = {}
        for d in np.flatnonzero(~recovered):
            k = int(k_scan[d] + step)
            if k != bv2.RETRY_UP:
                dens.setdefault(k, []).append(d)
        if not dens:
            break
        clips3r = np.zeros((n_devices, T2), dtype=np.float32)
        nv3r = np.zeros(n_devices, dtype=np.int32)
        for den, members in dens.items():
            yr, n_out = res_fn(jnp.asarray(clips3), den)
            yr_np = np.asarray(yr)
            L = min(n_out, T2)
            for d in members:
                clips3r[d, :L] = yr_np[d, :L]
                nv3r[d] = min((int(nv3[d]) * bv2.RETRY_UP) // den, L)
        out4 = run2(jnp.asarray(clips3r), jnp.asarray(nv3r))
        v4 = bv2._finish_ladder(out4, nonce, True, 1 << 20,
                                real=nv3r > 0)
        recovered |= v4
    n_rec = int(recovered.sum())
    assert n_rec == n_devices, (
        f"sharded recovery lost clips "
        f"{np.flatnonzero(~recovered).tolist()} "
        f"(pre-scan verdicts {v3.astype(int).tolist()}, factors "
        f"{[round(float(x), 5) for x in factors]})")

    print(f"DRYRUN_OK n_devices={n_devices} "
          f"verdicts={verdicts.astype(int).tolist()} n_crc_ok={n_crc_ok} "
          f"v2_verdicts={v2_verdicts.astype(int).tolist()} "
          f"v2_n_crc_ok={n_crc2} recovered={n_rec}")
    return {"nonce": nonce,
            "compat": {"inputs": (clips, n_valid), "verdicts": verdicts},
            "v2": {"inputs": (clips2, nv2), "verdicts": v2_verdicts}}


if __name__ == "__main__":
    import os
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()

    import jax

    # pin the CPU platform BEFORE first backend use (the env var alone is
    # too late if a plugin already set the platform list)
    jax.config.update("jax_platforms", "cpu")
    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    run(n)
