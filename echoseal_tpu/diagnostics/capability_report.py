"""Measured capability envelope: accept rates across hosts x impairments.

Runs the single-clip verifier over a grid of host signals and channel
impairments and prints a JSON report -- the ground truth behind the
documented claim that the reference-compatible wire format only survives
digitally-clean capture (and behind future robust-profile comparisons).
"""
from __future__ import annotations

import json

import numpy as np


def main(key: bytes = b"\xaa" * 32, seconds: float = 4.0) -> None:
    from echoseal_tpu.models.detector import WatermarkDetector
    from echoseal_tpu.models.embedder import BatchEmbedder
    from echoseal_tpu.utils import channels

    fs = 48_000
    n = int(seconds * fs)
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs

    hosts = {
        "silence": np.zeros(n, np.float32),
        "tone1k@-20dB": (0.1 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
        "noise@-40dB": (0.01 * rng.standard_normal(n)).astype(np.float32),
    }
    impairments = {
        "clean": lambda x: x,
        "mp3-128k(sim)": lambda x: channels.codec_sim(x, 128.0),
        "awgn-15dB": lambda x: channels.awgn(x, -15.0),
        "timescale+5%": lambda x: channels.time_scale(x, 1.05),
        "lowpass3.5k": lambda x: channels.lowpass(x, 3500.0),
        "dropout": lambda x: channels.dropout(x, 5.0, 0.5),
        "reverb(6dB,150ms)": lambda x: channels.reverb(
            x, 150.0, direct_to_reverb_db=6.0),
    }

    from echoseal_tpu.models.robust import RobustEmbedder, RobustVerifier

    be = BatchEmbedder(key)
    report = {}
    for hname, host in hosts.items():
        wm = be.embed(host, session_nonce=b"capcheck")
        tx2 = RobustEmbedder(key)
        wm2 = tx2.process(host.copy())
        det = WatermarkDetector(key, list_size=16)
        rv = RobustVerifier(key)
        row = {}
        for iname, f in impairments.items():
            det.session_nonce = None
            rv.session_nonce = None
            try:
                compat = bool(det.verify(f(wm.copy()), fs))
            except Exception as e:  # pragma: no cover
                compat = f"ERROR: {e}"
            try:
                v2 = bool(rv.verify(f(wm2.copy()), fs))
            except Exception as e:  # pragma: no cover
                v2 = f"ERROR: {e}"
            row[iname] = {"compat": compat, "v2": v2}
        report[hname] = row
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Measured capability envelope: accept rates across "
                    "hosts x impairments (JSON to stdout).")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="cpu forces XLA:CPU (e.g. when the accelerator "
                         "backend is down -- its init HANGS, not errors)")
    args = ap.parse_args()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    main(seconds=args.seconds)
