"""Seconds-to-first-decode probe: does the persistent compile cache work?

Every entry point (bench.py, chip_smoke.py, CLIs, benchmarks) enables
the persistent compile cache (utils/cache.py); this probe MEASURES
whether the backend actually persists artifacts: run it
twice back-to-back -- each run is a fresh process that appends a row
{run, platform, stages: {stage: seconds}} to the output JSON, so the
second row IS the second-process cold start.

Stages (each timed from a fresh-process perspective, tiny batches --
the point is compile amortization, not throughput):

* ``compat_first_verify`` -- BatchVerifier construction + first
  ``verify_batch`` (B=16)
* ``v2_first_verify``     -- RobustBatchVerifier construction + first
  ``verify_batch`` (B=16; includes the demod-table upload, which the
  cache can NOT amortize -- listed separately as ``v2_table_upload``
  when measurable)
* ``scl256_first_decode`` -- first SCL-256 decode at bucket 128

Usage: python benchmarks/compile_cache_probe.py [--out FILE]
       [--platform cpu] [--skip-scl256]
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
    ap.add_argument("--out", default="benchmarks/compile_cache_probe.json")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    ap.add_argument("--skip-scl256", action="store_true",
                    help="skip the ~320 s (uncached) SCL-256 stage")
    ap.add_argument("--label", default=None,
                    help="free-form row label (e.g. 'first-process')")
    args = ap.parse_args()

    if args.platform:
        import os

        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)

    from echoseal_tpu.utils.cache import enable_persistent_cache

    cache_dir = enable_persistent_cache()

    import jax

    from echoseal_tpu.core.params import FRAME_LEN
    from echoseal_tpu.models.embedder import BatchEmbedder
    from echoseal_tpu.models.pipeline import BatchVerifier, RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder

    key = bytes.fromhex("aa" * 32)
    fs = 48_000
    T = 3 * fs
    Tpad = 184_320
    B = 16
    stages: dict[str, float] = {}

    # ---- compat ---------------------------------------------------------
    t0 = time.perf_counter()
    be = BatchEmbedder(key)
    n_frames = -(-T // FRAME_LEN)
    scale = 10.0 ** (be.p.floor_rel_dbfs / 20.0)
    fr = be.frames(np.arange(n_frames), session_nonce=bytes(8))
    clips = np.zeros((B, Tpad), np.float32)
    clips[:, :T] = fr.reshape(-1)[:T] * scale
    nv = np.full(B, T, np.int32)
    bv = BatchVerifier(key, max_ctr=4096)
    v = bv.verify_batch(clips, nv)
    stages["compat_first_verify"] = round(time.perf_counter() - t0, 2)
    assert v.all(), "compat probe batch must verify"

    # ---- v2 -------------------------------------------------------------
    t0 = time.perf_counter()
    tx2 = RobustEmbedder(key)
    wm2 = tx2.process(np.zeros(int(3.5 * fs), np.float32))
    clips2 = np.zeros((B, Tpad), np.float32)
    clips2[:, : wm2.size] = wm2
    nv2 = np.full(B, wm2.size, np.int32)
    bv2 = RobustBatchVerifier(key, max_ctr=4096)
    v2 = bv2.verify_batch(clips2, nv2)
    stages["v2_first_verify"] = round(time.perf_counter() - t0, 2)
    assert v2.all(), "v2 probe batch must verify"

    # ---- SCL-256 --------------------------------------------------------
    if not args.skip_scl256:
        from echoseal_tpu.ops.polar import encode_np, polar_spec
        from echoseal_tpu.ops.scl import scl_decode

        spec = polar_spec()
        rng = np.random.default_rng(0)
        bits = np.stack([encode_np(rng.bytes(55), spec)
                         for _ in range(128)])
        y = (2.0 * bits - 1.0) + 0.5 * rng.standard_normal(bits.shape)
        llr = (2.0 * y / 0.25).astype(np.float32)
        t0 = time.perf_counter()
        res = scl_decode(jax.numpy.asarray(llr), spec, 256)
        ok = np.asarray(res["crc_ok"])
        stages["scl256_first_decode"] = round(time.perf_counter() - t0, 2)
        assert ok.any(), "SCL-256 probe must decode"

    row = {
        "label": args.label,
        "platform": jax.default_backend(),
        "cache_dir": cache_dir,
        "stages": stages,
    }
    out = Path(args.out)
    hist = json.loads(out.read_text()) if out.exists() else {"runs": []}
    hist["runs"].append(row)
    out.write_text(json.dumps(hist, indent=2))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
