"""Timescale-recovery failure attribution: where do the ~5% die?

VERDICT r3 weak #3 / next #5: the batched recovery ladder accepted
0.908-0.943 of a fully +3.1%-time-scaled 1k batch while the single-clip
ladder recovers ~all -- this script instruments `verify_batch_recover`
(same TX stream, same clips as benchmarks/impaired_bench.py's timescale
row) to attribute every final failure to a ladder stage:

* ``no_candidate``   -- the scan argmaxed the identity AND the
  peak-spacing fine0 estimate abstained, so no retry was attempted;
* ``correct_factor`` -- a retry ran within the demod coherence budget
  of the true CORRECTION and STILL failed (clip-intrinsic: frame
  alignment / content, not estimation);
* ``wrong_factor``   -- every retry factor was off-true; records the
  per-round factor trajectory so scan-vs-refinement blame is visible.

Factor convention (pinned empirically -- tests/test_pipeline.py
factor-direction probe, round 4): ``channels.time_scale(x, s)`` plays
``s`` fast (length/s); the CORRECTION factor f resamples by 1/f, so the
correct correction for an ``s``-scaled clip is f = 1/s, i.e.
|f*s - 1| <= tol.  (An earlier revision tested |f/s - 1| -- inverted --
which mislabeled every correct-factor failure as ``wrong_factor`` and
spawned the round-4 'reciprocal aliasing' misdiagnosis.)

The attribution drives (and afterwards documents) the accept fixes:
whatever class dominates is the stage to repair.

Run: python benchmarks/timescale_attrib.py [--batch 256] [--factor 1.031]
     [--platform cpu] [--out benchmarks/timescale_attrib.json]
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
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--factor", type=float, default=1.031)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    args = ap.parse_args()

    if args.platform:
        import os

        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)

    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import jax

    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    key = bytes.fromhex("aa" * 32)
    fs = 48_000
    T = int(3.5 * fs)
    Tpad = 184_320
    rng = np.random.default_rng(0)
    B = args.batch
    true_f = args.factor

    host = (0.15 * np.sin(2 * np.pi * 700
                          * np.arange(int(12 * fs)) / fs)).astype(np.float32)
    stream = RobustEmbedder(key).process(host)
    starts = rng.integers(0, stream.size - T, size=B)
    base2 = np.stack([stream[s: s + T] for s in starts])

    bv2 = RobustBatchVerifier(key)
    nv2 = np.full(B, T, dtype=np.int32)

    clips = np.zeros((B, Tpad), dtype=np.float32)
    nvr = nv2.copy()
    for i in range(B):
        y = channels.time_scale(base2[i].copy(), true_f)
        L = min(y.size, Tpad)
        clips[i, :L] = y[:L]
        nvr[i] = L

    # spy on every _retry_scaled round: factors tried + per-clip rescue
    rounds: list[dict] = []
    orig = RobustBatchVerifier._retry_scaled

    def spy(self, c, nv, factors, verdicts, nonce, refine, **kw):
        before = verdicts.copy()
        out = orig(self, c, nv, factors, verdicts, nonce, refine, **kw)
        rounds.append(dict(
            factors={int(k): float(v) for k, v in factors.items()},
            rescued=sorted(int(i) for i in np.flatnonzero(out & ~before)),
        ))
        return out

    RobustBatchVerifier._retry_scaled = spy
    try:
        import jax.numpy as jnp

        clips_dev = jax.device_put(jnp.asarray(clips))
        float(np.asarray(jnp.sum(clips_dev)))       # upload barrier
        bv2.verify_batch_recover(clips_dev, nvr)    # warm all compiles
        rounds.clear()
        t0 = time.perf_counter()
        v = bv2.verify_batch_recover(clips_dev, nvr)
        secs = time.perf_counter() - t0
    finally:
        RobustBatchVerifier._retry_scaled = orig

    # NOTE: _retry_scaled recurses, so rounds[] arrives innermost-first;
    # re-key by the factors a clip was tried at instead of round order.
    tried: dict[int, list[float]] = {}
    for rd in rounds:
        for i, f in rd["factors"].items():
            tried.setdefault(i, []).append(f)

    fails = np.flatnonzero(~v)
    tol = 2e-4
    attrib: dict[str, list] = {
        "no_candidate": [], "correct_factor": [], "wrong_factor": []}
    for i in fails:
        fs_tried = tried.get(int(i), [])
        if not fs_tried:
            attrib["no_candidate"].append(dict(clip=int(i)))
        elif any(abs(f * true_f - 1.0) <= tol for f in fs_tried):
            attrib["correct_factor"].append(
                dict(clip=int(i), tried=[round(f, 6) for f in fs_tried]))
        else:
            attrib["wrong_factor"].append(
                dict(clip=int(i), tried=[round(f, 6) for f in fs_tried]))

    report = dict(
        batch=B, true_factor=true_f, platform=jax.default_backend(),
        secs=round(secs, 3), accept=float(np.mean(v)),
        audio_sec_per_sec=round(B * T / fs / secs, 1),
        n_fail=int(fails.size),
        n_retry_rounds=len(rounds),
        fail_classes={k: len(xs) for k, xs in attrib.items()},
        failures=attrib,
    )
    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
