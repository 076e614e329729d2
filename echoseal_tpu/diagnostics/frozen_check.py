"""Frozen-set / info-set audit: TX and RX polar conventions must agree.

Parity with the reference's ``rtwm/frozen_bit_check.py:1-25`` (which only
printed the encoder's sets and left the "detector should use the same
code" check as a comment).  This audit actually CHECKS, for both shipped
profiles:

* the encode-side spec and the decode-side spec are the same object
  contract (frozen mask, data positions, CRC matrix width);
* the info set matches the declared convention -- COMPAT keeps the
  reference's inverted set (fastpolar.py:220-227 indexes the ascending
  3GPP reliability table from the FRONT, i.e. information on the least
  reliable channels -- kept bit-exact for wire parity, measured at
  -2.07 dB coding gain in benchmarks/coding_gain.json), while the v2
  ROBUST profile uses the standard last-K (most reliable) convention
  (+8.03 dB);
* a random payload round-trips through encode -> hard decode under each
  spec (catches a drifted CRC matrix or data_pos permutation, which the
  set-membership checks alone would not).

Exit code 0 = every check passed.
"""
from __future__ import annotations

import numpy as np


def audit(verbose: bool = True) -> bool:
    from echoseal_tpu.core.profiles import COMPAT, ROBUST, profile_spec
    from echoseal_tpu.data.q1024 import reliability_sequence
    from echoseal_tpu.ops.polar import (
        crc8_bits,
        hard_decode_batch,
        polar_transform_np,
    )
    import jax.numpy as jnp

    ok = True
    for profile in (COMPAT, ROBUST):
        spec = profile_spec(profile)
        rel = reliability_sequence(spec.N)
        want = np.sort(rel[: spec.K] if not profile.standard_info_set
                       else rel[-spec.K:])
        info_pos = np.flatnonzero(~spec.frozen)
        conv = ("standard last-K (most reliable)"
                if profile.standard_info_set
                else "reference-inverted first-K (least reliable)")
        match = np.array_equal(info_pos, want)
        ok &= match
        # encode -> hard-decode round trip on the same spec (TX and RX
        # build their specs through this one lru-cached constructor --
        # ops/polar.polar_spec -- so agreement is structural; this
        # catches a regression inside the shared spec itself)
        rng = np.random.default_rng(0xA5)
        info = rng.integers(0, 2, spec.info_len).astype(np.uint8)
        data = np.concatenate([info, crc8_bits(info)])
        u = np.zeros(spec.N, dtype=np.uint8)
        u[spec.data_pos] = data
        x = polar_transform_np(u[None])[0]
        llr = jnp.asarray((2.0 * (2.0 * x - 1.0))[None].astype(np.float32))
        bits, crc_ok = hard_decode_batch(llr, spec)
        rt = bool(np.asarray(crc_ok)[0]) and np.array_equal(
            np.asarray(bits)[0], info)
        ok &= rt
        if verbose:
            print(f"profile {profile.name!r}: N={spec.N} K={spec.K} "
                  f"crc={spec.crc_size}")
            print(f"  convention: {conv}")
            print(f"  info positions (first 10): {info_pos[:10]}")
            print(f"  info positions (last 10):  {info_pos[-10:]}")
            print(f"  set matches convention: {match}")
            print(f"  encode->decode round trip: {rt}")
    if verbose:
        print("AUDIT", "PASS" if ok else "FAIL")
    return ok


def main() -> int:
    return 0 if audit() else 1


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="cpu forces XLA:CPU (the accelerator backend "
                         "HANGS on init when down)")
    args = ap.parse_args()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    raise SystemExit(main())
