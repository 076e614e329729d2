"""Compat tier parity: single-clip detector vs batched serving pipeline.

VERDICT r2 weak #7 / next-step #6: the single-clip detector runs a full
raw-chip SCL ladder and scores both demod model variants
(models/detector.py), while the compat serving tier is hard-decision only
with ``peaks=2`` (models/pipeline.py).  Does a clip class exist that
verifies single-clip but fails the batch tier?

This harness runs every class of clip the compat format can carry at all
(measured envelope: digitally-clean captures -- see ops/demod.py) through
BOTH tiers and reports accept rates + wall time.  Classes:

* clean        -- watermark-only stream from sample 0 (frame aligned)
* midcut       -- clips cut at random NON-frame-aligned offsets
* excerpt      -- 3.5 s excerpts of a longer stream (utils.channels)
* dropout      -- 5 ms zeroed bursts at 0.5 Hz
* high_ctr     -- clips whose counters sit past the device PN table
                  (extended lo16+m*2^16 resolution in both tiers)

Run: ``python benchmarks/tier_compare.py [--per-class 8] [--platform cpu]``
Writes benchmarks/tier_compare.json with ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-class", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    args = ap.parse_args()

    if args.platform:
        import os

        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)

    # every backend (VERDICT r3 Missing #3): persistence is a no-op
    # where the PJRT plugin cannot serialize executables
    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from echoseal_tpu.core.params import FRAME_LEN
    from echoseal_tpu.models.detector import WatermarkDetector
    from echoseal_tpu.models.embedder import BatchEmbedder
    from echoseal_tpu.models.pipeline import BatchVerifier
    from echoseal_tpu.utils import channels

    key = bytes.fromhex("aa" * 32)
    fs = 48_000
    T = int(3.5 * fs)
    n = args.per_class
    rng = np.random.default_rng(42)

    be = BatchEmbedder(key)
    scale = 10.0 ** (be.p.floor_rel_dbfs / 20.0)
    long_stream = be.chip_stream(int(12 * fs), start_ctr=0,
                                 session_nonce=bytes(8)) * scale
    hi_stream = be.chip_stream(int(8 * fs), start_ctr=70_000,
                               session_nonce=bytes(8)) * scale

    def fresh_stream(start):
        return be.chip_stream(T + FRAME_LEN, start_ctr=start,
                              session_nonce=bytes(8)) * scale

    classes: dict[str, list[np.ndarray]] = {
        "clean": [fresh_stream(int(rng.integers(0, 4000)))[:T]
                  for _ in range(n)],
        "midcut": [long_stream[off : off + T]
                   for off in rng.integers(1, long_stream.size - T, size=n)],
        "excerpt": [channels.excerpt(long_stream, 3.5, rng=rng)
                    for _ in range(n)],
        "dropout": [channels.dropout(long_stream[:T].copy(), burst_ms=5.0,
                                     rate_hz=0.5, rng=rng)
                    for _ in range(n)],
        "high_ctr": [hi_stream[off : off + T]
                     for off in rng.integers(0, hi_stream.size - T, size=n)],
    }

    bv = BatchVerifier(key)
    report: dict = {"per_class": n, "platform": None, "classes": {}}
    import jax

    report["platform"] = jax.default_backend()

    for name, clips in classes.items():
        # ---- single-clip tier (fresh detector per clip: no replay latch)
        t0 = time.perf_counter()
        single = [WatermarkDetector(key, list_size=256).verify(c, fs)
                  for c in clips]
        t_single = time.perf_counter() - t0

        # ---- batch tier
        Tpad = 1 << 18
        batch = np.zeros((len(clips), Tpad), np.float32)
        nv = np.zeros(len(clips), np.int32)
        for i, c in enumerate(clips):
            batch[i, : c.size] = c
            nv[i] = c.size
        t0 = time.perf_counter()
        verd = bv.verify_batch(batch, nv)
        t_batch = time.perf_counter() - t0

        row = dict(
            single_accept=float(np.mean(single)),
            batch_accept=float(np.mean(verd)),
            single_secs=round(t_single, 2),
            batch_secs=round(t_batch, 2),
            diverging=int(np.sum(np.asarray(single) != np.asarray(verd))),
        )
        report["classes"][name] = row
        print(name, row, flush=True)

    report["any_divergence"] = any(
        r["diverging"] for r in report["classes"].values())
    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
