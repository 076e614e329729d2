"""Polar codec AWGN sweep: BLER for both info-set conventions.

Quantifies the reference's inverted information set (fastpolar.py:220-227
indexes the ascending 3GPP table from the front, putting information on
the LEAST reliable channels) against the standard convention -- the
decisive data point behind the robust v2 profile.
"""
from __future__ import annotations

import numpy as np


def _spec_standard(N: int = 1024, K: int = 448, crc: int = 8):
    """PolarSpec with the STANDARD convention (last-K = most reliable)."""
    from echoseal_tpu.data.q1024 import reliability_sequence
    from echoseal_tpu.ops.polar import PolarSpec, crc8_matrix

    rel = reliability_sequence(N)
    frozen = np.ones(N, dtype=bool)
    frozen[rel[-K:]] = False
    return PolarSpec(N=N, K=K, crc_size=crc, frozen=frozen,
                     data_pos=np.flatnonzero(~frozen),
                     crc_mat=crc8_matrix(K - crc))


def main(trials: int = 16, list_size: int = 8) -> None:
    import jax.numpy as jnp

    from echoseal_tpu.ops.polar import (
        crc8_bits,
        polar_spec,
        polar_transform_np,
    )
    from echoseal_tpu.ops.scl import scl_decode

    rng = np.random.default_rng(0)
    specs = {
        "reference (inverted)": polar_spec(),
        "standard 5G": _spec_standard(),
    }
    print(f"{'convention':>22} {'sigma':>6} {'chipBER':>8} {'BLER':>6}")
    for name, spec in specs.items():
        for sigma in (0.3, 0.5, 0.7, 0.9):
            llrs, infos = [], []
            for _ in range(trials):
                info = rng.integers(0, 2, spec.info_len).astype(np.uint8)
                data = np.concatenate([info, crc8_bits(info)])
                u = np.zeros(spec.N, dtype=np.uint8)
                u[spec.data_pos] = data
                x = polar_transform_np(u[None])[0]
                y = (2.0 * x - 1.0) + sigma * rng.standard_normal(spec.N)
                llrs.append((2.0 * y / sigma**2).astype(np.float32))
                infos.append(info)
            res = scl_decode(jnp.asarray(np.stack(llrs)), spec, list_size)
            ok = np.asarray(res["crc_ok"])
            bits = np.asarray(res["info_bits"])
            n_ok = sum(
                any(np.array_equal(bits[i, li], infos[i])
                    for li in np.flatnonzero(ok[i]))
                for i in range(trials))
            import math
            ber = 1 - 0.5 * (1 + math.erf(1 / (sigma * 2**0.5)))
            print(f"{name:>22} {sigma:>6.2f} {ber:>8.4f} "
                  f"{1 - n_ok / trials:>6.2f}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="cpu forces XLA:CPU (the accelerator backend "
                         "HANGS on init when down)")
    args = ap.parse_args()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    main(trials=args.trials, list_size=args.list_size)
