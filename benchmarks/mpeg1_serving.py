"""Serving-scale verification through the REAL MPEG-1 Layer II codec.

codec_envelope.py proves the v2 profile survives the in-repo
perceptual-transform codec (utils/mpeg1.py) on independent single-clip
draws; this harness proves it AT SERVING SCALE: a batch of mid-stream v2
clips is encoded->decoded through MPEG-1 Layer II at 128 kbps (real
32-band polyphase + psychoacoustic bit allocation + bitstream, not the
windowed-DFT ``codec_sim`` the historical impaired_1k row uses) and
verified through the batched pipeline in one ladder pass, with a
wrong-key control on the same decoded audio.

The encode runs on the host OUTSIDE the timed region (like every channel
impairment in impaired_bench.py); the measured seconds are the verify
ladder only.  Default batch 256: the image is single-core and the numpy
codec runs ~2x real-time, so the 1024-clip default of impaired_bench
would spend ~30 min of untimed host encode for the same evidence.

Run: python benchmarks/mpeg1_serving.py [--batch 256] [--bitrate 128]
     [--platform cpu] [--out benchmarks/mpeg1_serving.json]
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
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--bitrate", type=int, default=128)
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
    import jax.numpy as jnp

    from echoseal_tpu.models.pipeline import RobustBatchVerifier
    from echoseal_tpu.models.robust import RobustEmbedder
    from echoseal_tpu.utils import channels

    key = bytes.fromhex("aa" * 32)
    wrong = bytes.fromhex("55" * 32)
    fs = 48_000
    T = int(3.5 * fs)
    Tpad = 184_320                      # impaired_bench's stage width
    rng = np.random.default_rng(0)
    B = args.batch

    host = (0.15 * np.sin(2 * np.pi * 700
                          * np.arange(int(12 * fs)) / fs)).astype(np.float32)
    stream = RobustEmbedder(key).process(host)
    starts = rng.integers(0, stream.size - T, size=B)

    t0 = time.perf_counter()
    clips = np.zeros((B, Tpad), dtype=np.float32)
    for i in range(B):
        y = channels.codec_mpeg1_l2(stream[starts[i]: starts[i] + T].copy(),
                                    args.bitrate)
        clips[i, :T] = y[:T]
        if (i + 1) % 64 == 0:
            print(f"encoded {i + 1}/{B}", flush=True)
    encode_s = time.perf_counter() - t0
    nv = np.full(B, T, dtype=np.int32)
    clips_dev = jax.device_put(jnp.asarray(clips))
    float(np.asarray(jnp.sum(clips_dev)))        # upload barrier

    report = dict(batch=B, bitrate_kbps=args.bitrate,
                  platform=jax.default_backend(),
                  host_encode_secs=round(encode_s, 1))
    for tag, k in (("accept", key), ("wrong_key_accept", wrong)):
        bv = RobustBatchVerifier(k)
        bv.verify_batch(clips_dev, nv)           # warm compiles
        t0 = time.perf_counter()
        v = bv.verify_batch(clips_dev, nv)
        dt = time.perf_counter() - t0
        report[tag] = float(np.mean(v))
        report[f"{tag}_secs"] = round(dt, 3)
        report[f"{tag}_audio_sec_per_sec"] = round(B * T / fs / dt, 1)
        print(json.dumps({tag: report[tag], "secs": report[f"{tag}_secs"]}),
              flush=True)

    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
