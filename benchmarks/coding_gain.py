"""Measured FEC coding gain vs the reference's unreproduced 4.2 dB claim.

The reference README claims "4.2 dB coding gain" for its Polar(1024,448)
+CRC-8 SCL stack (reference README.md:45) and publishes no measurement
(SURVEY.md §6).  This measures the real number for BOTH info-set
conventions this repo carries:

* **compat** -- the reference's own convention (first-K of the
  most->least-reliable Q table, reproduced bit-exactly for wire parity;
  `ops/polar.py`).  This places the information on POOR channels, so
  the measurement quantifies how far the shipped reference code
  actually is from its claim.
* **standard** -- the v2 profile's convention (most-reliable channels,
  `core/profiles.py:polar_spec_standard`), i.e. what the table is for.

Method: BPSK over AWGN, exact LLRs (2y/sigma^2), SCL-32 batch decode at
each sigma on a grid bracketing the FER=1e-2 waterfall; success = the
best CRC-passing path reproduces the 440 payload bits.  sigma* at
FER=1e-2 by log-FER interpolation.  Baseline: uncoded BPSK carrying the
same 440-bit frame, FER_u(sigma) = 1-(1-Q(1/sigma))^440 (closed form).
Coding gain = Eb/N0_uncoded - Eb/N0_coded at FER=1e-2, with the coded
energy per info bit Eb = (N/440)*Es (CRC counted as overhead).

Writes ``coding_gain.json``.

Usage: python benchmarks/coding_gain.py [--out FILE] [--platform cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmarks/coding_gain.json")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--list-size", type=int, default=32)
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    # every backend (VERDICT r3 Missing #3): persistence is a no-op
    # where the PJRT plugin cannot serialize executables
    from echoseal_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.stats import norm

    from echoseal_tpu.core.profiles import polar_spec_standard
    from echoseal_tpu.ops.polar import encode_np, polar_spec
    from echoseal_tpu.ops.scl import scl_decode

    K_INFO = 440  # payload bits per frame; CRC-8 is overhead
    rng = np.random.default_rng(0)

    def fer_at(spec, sigma: float) -> float:
        payloads = [rng.bytes(55) for _ in range(args.frames)]
        bits = np.stack([encode_np(p, spec) for p in payloads])
        truth = np.stack([np.unpackbits(np.frombuffer(p, np.uint8))
                          for p in payloads]).astype(np.int32)
        y = (2.0 * bits - 1.0) + sigma * rng.standard_normal(bits.shape)
        llr = jnp.asarray((2.0 * y / sigma**2).astype(np.float32))
        errs = 0
        for i in range(0, args.frames, 128):
            out = scl_decode(llr[i : i + 128], spec, args.list_size)
            ok = np.asarray(out["crc_ok"])                 # (b, L)
            info = np.asarray(out["info_bits"])            # (b, L, 440)
            first = np.argmax(ok, axis=1)                  # best CRC path
            sel = np.take_along_axis(
                info, first[:, None, None], 1)[:, 0]
            good = ok.any(1) & (sel == truth[i : i + 128]).all(1)
            errs += int((~good).sum())
        return errs / args.frames

    def waterfall(spec, grid, label):
        rows = []
        for s in grid:
            t0 = time.perf_counter()
            f = fer_at(spec, float(s))
            rows.append({"sigma": float(s), "fer": f})
            print(f"{label} sigma={s:.3f}: FER={f:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)")
            if f == 0.0 and len(rows) >= 2:
                break
        return rows

    def sigma_star(rows, target=1e-2):
        """log-FER interpolation for the sigma where FER crosses target."""
        pts = sorted(((r["sigma"], r["fer"]) for r in rows))
        for (s0, f0), (s1, f1) in zip(pts, pts[1:]):
            if f0 <= target <= f1 and f1 > 0:
                lf0 = np.log10(max(f0, 1.0 / (10 * args.frames)))
                lf1 = np.log10(f1)
                w = (np.log10(target) - lf0) / (lf1 - lf0)
                return float(s0 + w * (s1 - s0))
        return None

    specs = {
        "compat_reference_convention": (
            polar_spec(), np.arange(0.26, 0.40, 0.01)[::-1]),
        "standard_v2_convention": (
            polar_spec_standard(), np.arange(0.40, 1.05, 0.05)[::-1]),
    }
    report = {"frames_per_point": args.frames,
              "list_size": args.list_size, "k_info": K_INFO}

    # closed-form uncoded baseline at the same frame size
    def fer_uncoded(sigma):
        return 1.0 - (1.0 - norm.sf(1.0 / sigma)) ** K_INFO

    from scipy.optimize import brentq

    s_u = brentq(lambda s: fer_uncoded(s) - 1e-2, 0.05, 1.0)
    ebn0_u = 10 * np.log10(1.0 / (2 * s_u**2))
    report["uncoded"] = {"sigma_star": round(s_u, 4),
                         "ebn0_db_at_fer1e-2": round(ebn0_u, 2)}

    rate_penalty_db = 10 * np.log10(1024 / K_INFO)
    for name, (spec, grid) in specs.items():
        rows = waterfall(spec, grid, name)
        s_c = sigma_star(rows)
        entry = {"rows": rows, "sigma_star": s_c}
        if s_c:
            ebn0_c = 10 * np.log10(1.0 / (2 * s_c**2)) + rate_penalty_db
            entry["ebn0_db_at_fer1e-2"] = round(float(ebn0_c), 2)
            entry["coding_gain_db"] = round(float(ebn0_u - ebn0_c), 2)
        report[name] = entry
        print(f"{name}: sigma*={s_c} gain={entry.get('coding_gain_db')} dB")

    import jax as _j

    report["platform"] = _j.default_backend()
    report["reference_claim_db"] = 4.2
    out = json.dumps(report, indent=2)
    print(out)
    Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
