"""Measured v2 acoustic-capture envelope: verdict over (DRR, RT60).

Sweeps the synthetic room impulse response (utils/channels.py:
direct-to-reverberant ratio x RT60, physical early reflections) against
single-clip v2 verification, over several independent RIR draws per
point.  Produces ``reverb_envelope.json`` -- the measured artifact
behind the README/ALGORITHM.md acoustic-capture claims and the
tests/test_robust.py pins.

The verdict math is platform-identical (same XLA program modulo f32
rounding); the JSON records which backend produced it.

Usage: python benchmarks/reverb_envelope.py [--out FILE] [--platform cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmarks/reverb_envelope.json")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    ap.add_argument("--draws", type=int, default=3,
                    help="independent RIR draws per grid point")
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    # every backend (VERDICT r3 Missing #3): persistence is a no-op
    # where the PJRT plugin cannot serialize executables
    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import numpy as np

    from echoseal_tpu.models.robust import RobustEmbedder, RobustVerifier
    from echoseal_tpu.utils import channels

    key = bytes.fromhex("aa" * 32)
    fs = 48_000
    T = int(3.5 * fs)
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / fs)
            ).astype(np.float32)
    tx = RobustEmbedder(key)
    tx._session_nonce = b"reverbEV"
    wm = tx.process(host)
    rv = RobustVerifier(key)

    grid_d2r = (20.0, 12.0, 6.0, 3.0, 0.0, -3.0)
    grid_rt60 = (50.0, 150.0, 400.0, 800.0)
    rows = []
    for d2r in grid_d2r:
        for rt in grid_rt60:
            accepts, stages = [], []
            for k in range(args.draws):
                y = channels.reverb(wm, rt, direct_to_reverb_db=d2r,
                                    rng=np.random.default_rng(100 + k))
                r = rv.verify_detailed(y, fs)
                accepts.append(bool(r.authentic))
                stages.append(getattr(r, "stage", None))
            rows.append({"d2r_db": d2r, "rt60_ms": rt,
                         "accept": sum(accepts) / len(accepts),
                         "stages": stages})
            print(f"d2r={d2r:>5} rt60={rt:>5}: "
                  f"accept={rows[-1]['accept']:.2f} stages={stages}")

    # combined impairments: does acoustic capture stack with the rest?
    def rev(x, d2r=6.0):
        return channels.reverb(x, 150.0, direct_to_reverb_db=d2r,
                               rng=np.random.default_rng(9))

    cases = {
        "reverb6+mp3sim": channels.codec_sim(rev(wm), 128.0)[:T],
        "mp3sim+reverb6": rev(channels.codec_sim(wm, 128.0)[:T]),
        "reverb6+excerpt3s": channels.excerpt(
            rev(wm), 3.0, rng=np.random.default_rng(2)),
        # marginal row: reverb smears the sync peaks the time-scale
        # estimator uses, so recovery of re-scaled playback through a
        # 6 dB-DRR room is payload-dependent (measured both accept and
        # reject across session nonces) -- treat this row as a coin,
        # not a guarantee
        "reverb6+timescale1.031": channels.time_scale(rev(wm), 1.031),
    }
    combined = {}
    for name, y in cases.items():
        rv.session_nonce = None
        r = rv.verify_detailed(np.ascontiguousarray(y), fs)
        combined[name] = {"accept": bool(r.authentic),
                          "stage": getattr(r, "stage", None)}
        print(f"{name}: {combined[name]}")

    report = {"platform": jax.default_backend(),
              "host": "700 Hz tone, watermark ~11x below",
              "clip_s": 3.5, "draws": args.draws, "rows": rows,
              "combined": combined}
    out = json.dumps(report, indent=2)
    print(out)
    Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
