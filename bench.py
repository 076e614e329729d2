"""Headline benchmark: batched RX verification real-time factor per GPU.

Measures the BASELINE.json north-star metric -- audio-seconds verified per
wall-second per device on 3 s 48 kHz clips -- on the batched verify
pipeline (echoseal_tpu/models/pipeline.py), plus two sub-metrics: the v2
(robust-profile) serving real-time factor and the SCL-256 list decoder
throughput (the shipped default list size).

Clips are genuine watermarked streams (batched device TX, silence host for
the compat profile / loud tone host for v2; staged as in chip_smoke.py);
the timing covers the full pipeline: device dispatch (sync, demod, refine,
header, despread, polar+CRC) plus host AEAD verdicts.

``vs_baseline`` is value / 1000: the fraction of the 1000x-real-time
target.  (The reference NumPy implementation needs >560 s for a single
3 s clip -- real-time factor < 0.006 -- so a reference-relative ratio
would be vacuous.)

Runs in one process and needs a GPU: with none, or when any metric fails,
it exits non-zero and prints no result.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extras"}, with the device
(platform, kind, count, card name and power limit) in ``extras.device``.

    python bench.py
"""
from __future__ import annotations

import json
import time

import numpy as np

B = 1024            # served batch (the per-batch dispatch amortizes)
REPS = 3


def _best_of(fn, reps: int = REPS) -> float:
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    from echoseal_tpu.utils.device import gpu_info

    info = gpu_info()

    import jax
    import jax.numpy as jnp

    import chip_smoke as staging
    from echoseal_tpu.models.pipeline import BatchVerifier, RobustBatchVerifier
    from echoseal_tpu.ops.polar import encode_np, polar_spec
    from echoseal_tpu.ops.scl import scl_decode
    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    key, clip_s, T = staging.KEY, staging.CLIP_S, staging.T
    rng = np.random.default_rng(0)
    extras: dict = {"device": info}

    # ================= metric 1: compat headline RTF =====================
    clips = staging.compat_clips(B, rng)
    nv_dev = jnp.full(B, T, dtype=jnp.int32)
    bv = BatchVerifier(key)

    def run():
        out = bv.run_device(clips, nv_dev)
        # host AEAD verdict on the (tiny) device outputs is IN the timing
        return bv.finish_host(out)

    compat_accept = float(np.mean(run()))
    compat_rtf = B * clip_s / _best_of(run)
    extras["compat_accept"] = round(compat_accept, 3)

    # ================= metric 2: v2 (robust) serving RTF =================
    v2_clips = staging.v2_clips(staging.v2_stream(), B, rng)
    nv = np.full(B, T, dtype=np.int32)
    bv2 = RobustBatchVerifier(key)

    def run_v2():
        # the real serving call: hard pass + SCL fallback + extended ctrs
        return bv2.verify_batch(v2_clips, nv)

    v2_accept = float(np.mean(run_v2()))
    extras["v2_rtf_audio_sec_per_sec"] = round(B * clip_s / _best_of(run_v2),
                                               1)
    extras["v2_accept"] = round(v2_accept, 3)
    extras["v2_batch"] = B

    # ================= metric 3: SCL-256 decoder throughput ==============
    spec = polar_spec()
    n_dec = 128
    bits = np.stack([encode_np(rng.bytes(55), spec) for _ in range(n_dec)])
    y = (2.0 * bits - 1.0) + 0.3 * rng.standard_normal(bits.shape)
    llr = jnp.asarray((2.0 * y / 0.09).astype(np.float32))

    def run_scl():
        return jax.block_until_ready(scl_decode(llr, spec, 256)["crc_ok"])

    run_scl()
    extras["scl256_decodes_per_sec"] = round(n_dec / _best_of(run_scl), 1)
    extras["scl256_batch"] = n_dec

    value = round(compat_rtf, 1)
    print(json.dumps({
        "metric": (f"RX verify real-time factor (3s 48kHz clips, batch {B},"
                   f" accept_rate {compat_accept:.2f})"),
        "value": value, "unit": "audio-sec/sec/device",
        "vs_baseline": round(value / 1000.0, 3), "extras": extras}))


if __name__ == "__main__":
    main()
