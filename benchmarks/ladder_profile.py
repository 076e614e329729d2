"""Escalation-ladder profiler: where do the impaired v2 seconds go?

Mirrors the v2 rows of ``impaired_bench.py`` (same TX stream, same
impairments, same warmups) but splits each row's wall time by ladder
stage (hard pass / SCL download / SCL decode per bucket / extended
counter pass / recovery scan + retry) via the Timer registry, and
collects the per-clip EVIDENCE statistics (best soft-row mean |LLR|,
any readable header) split by outcome class -- the calibration data for
the futility gate (clips with no evidence must not enter the ladder).

Run: ``python benchmarks/ladder_profile.py [--batch 1024] [--out f.json]``
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parents[1]))


def _timer_diff(before: dict) -> dict:
    from echoseal_tpu.utils.logging import Timer

    out = {}
    for name, xs in Timer.registry.items():
        prev = before.get(name, 0)
        if len(xs) > prev:
            out[name] = dict(n=len(xs) - prev,
                             secs=round(sum(xs[prev:]), 3))
    return out


def _timer_snapshot() -> dict:
    from echoseal_tpu.utils.logging import Timer

    return {name: len(xs) for name, xs in Timer.registry.items()}


def _pct(a: np.ndarray) -> list[float]:
    if a.size == 0:
        return []
    return [round(float(v), 3)
            for v in np.percentile(a, [0, 5, 50, 95, 100])]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    ap.add_argument("--rows", default=None,
                    help="comma-separated subset of row names")
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

    import jax
    import jax.numpy as jnp

    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    key = bytes.fromhex("aa" * 32)
    fs = 48_000
    T = int(3.5 * fs)
    Tpad = 184_320
    rng = np.random.default_rng(0)
    B = args.batch

    host = (0.15 * np.sin(2 * np.pi * 700
                          * np.arange(int(12 * fs)) / fs)).astype(np.float32)
    stream = RobustEmbedder(key).process(host)
    starts = rng.integers(0, stream.size - T, size=B)
    base2 = np.stack([stream[s: s + T] for s in starts])

    bv2 = RobustBatchVerifier(key)
    nv2 = np.full(B, T, dtype=np.int32)

    impair = {
        "mp3-128k(sim)": lambda x: channels.codec_sim(x, 128.0)[: x.size],
        "awgn+6dB": lambda x: channels.awgn(x, 6.0, rng),
        "awgn-15dB": lambda x: channels.awgn(x, -15.0, rng),
        "timescale+3.1%": lambda x: channels.time_scale(x, 1.031),
        "reverb(6dB,150ms)": lambda x: channels.reverb(
            x, 150.0, direct_to_reverb_db=6.0, rng=rng),
    }
    if args.rows:
        keep = set(args.rows.split(","))
        impair = {k: v for k, v in impair.items() if k in keep}

    report: dict = {"batch": B, "platform": jax.default_backend()}

    # ---- warmups (mirror impaired_bench) --------------------------------
    t0 = time.perf_counter()
    warm = np.zeros((B, Tpad), dtype=np.float32)
    warm[:, :T] = base2[:, :T]
    bv2.verify_batch(jax.device_put(jnp.asarray(warm)), nv2)
    report["warm_plain_s"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    warm3 = np.zeros((B, Tpad), dtype=np.float32)
    nvw = nv2.copy()
    for i in range(B):
        y = channels.time_scale(base2[i].copy(), 1.031)
        L = min(y.size, Tpad)
        warm3[i, :L] = y[:L]
        nvw[i] = L
    bv2.verify_batch_recover(warm3, nvw)
    report["warm_recover_s"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    warm4 = np.zeros((B, Tpad), dtype=np.float32)
    for i in range(B):
        y = channels.codec_sim(base2[i].copy(), 128.0)[:T]
        warm4[i, : y.size] = y
    bv2.verify_batch(jax.device_put(jnp.asarray(warm4)), nv2)
    report["warm_escalation_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({k: report[k] for k in list(report)[-3:]}), flush=True)

    rows: dict = {}
    for name, f in impair.items():
        clips = np.zeros((B, Tpad), dtype=np.float32)
        nvr = nv2.copy()
        for i in range(B):
            y = f(base2[i].copy())
            L = min(y.size, Tpad)
            clips[i, :L] = y[:L]
            nvr[i] = L
        row: dict = {}
        snap = _timer_snapshot()
        if "timescale" in name:
            # pre-staged on device, mirroring impaired_bench's rows
            clips_dev = jax.device_put(jnp.asarray(clips))
            float(np.asarray(jnp.sum(clips_dev)))
            t0 = time.perf_counter()
            v = bv2.verify_batch_recover(clips_dev, nvr)
            row["secs"] = round(time.perf_counter() - t0, 3)
            row["accept"] = float(np.mean(v))
            row["stages"] = _timer_diff(snap)
        else:
            clips_dev = jax.device_put(jnp.asarray(clips))
            float(np.asarray(jnp.sum(clips_dev)))
            t0 = time.perf_counter()
            out = bv2.run_device(clips_dev, nvr)
            v_hard, _ = bv2.finish_host_detailed(out)
            row["hard_secs"] = round(time.perf_counter() - t0, 3)
            row["hard_accept"] = float(np.mean(v_hard))

            # evidence stats (untimed; forces extra downloads)
            q0 = np.asarray(jnp.mean(jnp.abs(out["scl_llr"][:, 0]), -1))
            hdr = np.asarray(jnp.any(
                out["hdr_ok"], axis=tuple(range(1, out["hdr_ok"].ndim))))

            t0 = time.perf_counter()
            verdicts = bv2._finish_ladder(out, None, True, 1 << 20,
                                          real=nvr > 0)
            row["ladder_secs"] = round(time.perf_counter() - t0, 3)
            row["accept"] = float(np.mean(verdicts))
            row["stages"] = _timer_diff(snap)

            rescued = verdicts & ~v_hard
            rejected = ~verdicts
            row["evidence"] = {
                "hard": dict(n=int(v_hard.sum()), q0=_pct(q0[v_hard]),
                             hdr_frac=round(float(hdr[v_hard].mean()), 3)
                             if v_hard.any() else None),
                "rescued": dict(n=int(rescued.sum()), q0=_pct(q0[rescued]),
                                hdr_frac=round(float(hdr[rescued].mean()), 3)
                                if rescued.any() else None),
                "rejected": dict(n=int(rejected.sum()), q0=_pct(q0[rejected]),
                                 hdr_frac=round(float(hdr[rejected].mean()),
                                                3)
                                 if rejected.any() else None),
            }
        rows[name] = row
        print(json.dumps({name: row}), flush=True)

    report["rows"] = rows
    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
