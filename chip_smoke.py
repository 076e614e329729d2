"""Smoke run of the batched verify path on one GPU, at the served width.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded streams mesh only

Run it from the repository root, one process per card (a JAX process
reserves most of the card's memory, so a second one would fail).  Phases,
in order, all in this one process:

1. device check -- every JAX device must be a GPU (no CPU fallback); prints
   JAX's platform / kind / count and the card's name and power limit.
2. compat served path -- ``BatchEmbedder`` clips (silence host), verified
   by ``BatchVerifier.run_device`` + ``finish_host`` (host AEAD included)
   at B=1024, T=3 s: accept 1.000 with the key, 0.000 with a wrong key.
3. v2 served path -- ``RobustEmbedder`` tone-host clips through
   ``RobustBatchVerifier.verify_batch`` (hard pass, SCL fallback, extended
   counters) at B=1024: accept 1.000 / 0.000; then 64 codec-simulated,
   3% time-scaled clips through ``verify_batch_recover``.
4. CLI -- ``echoseal-tx`` writes 4 WAVs, ``echoseal-rx --batch`` verifies
   them, for both profiles, called in-process.
5. GPU numerics vs the CPU reference -- both device stages on 8 clips, on
   the GPU and jitted onto the CPU in this process; SCL L=256 vs the dense
   oracle.
6. set-up and memory -- table build and cold-compile times, the v2
   stage's ``memory_analysis`` at B=1024, peak device memory, the compile
   cache's directory and entry counts.

Every failure raises, so the process exits non-zero and prints no result
line.  The last line of standard output is one JSON object naming the
device.  Times are informative, not records; each names the card.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from echoseal_tpu.core.params import FRAME_LEN
from echoseal_tpu.utils.device import gpu_info

KEY = bytes.fromhex("aa" * 32)
WRONG_KEY = bytes.fromhex("55" * 32)
FS = 48_000
CLIP_S = 3.0
T = int(CLIP_S * FS)
B = 1024                      # served batch (bench.py)
PAD_COMPAT = 8192             # clip padding of the compat / v2 batches
PAD_V2 = 16384
N_IMPAIRED = 64
N_NUMERICS = 8
SEED = 0

# GPU-vs-CPU tolerances.  Both backends run the f32 contractions at full
# precision (Precision.HIGHEST, no TF32); what differs is summation order
# (cuBLAS / cuDNN vs the CPU's dot kernels) over dot products of up to
# 9720 terms.  For the v2 stage (LS regularisation lam >= 1e-6, a mild
# inversion) that is ~1e-5 of the chip scale, so its chips are held to
# 1e-3 of their RMS, and its LLRs (unit-power chips scaled by
# 2a/sigma^2 <= 40, clipped to +-16) to 5e-2 absolute, and every
# decision must be identical.  The compat stage inverts with lam = 1e-12 a
# model whose weakest ~100 of 1215 singular values sit near 2.5e-6 of the
# largest (ops/demod.py), so rounding-order differences are amplified by
# up to ~4e5 along those directions, and the hard-projection refinement
# then anchors a chip there to +-amp on either side: a few chips in ~1e4
# flip sign between backends, and a flipped payload chip flips that
# candidate's CRC (measured: 1 to 7 of 64 candidates, both ways).
# Compat is therefore held to: identical verdicts; identical hard bits
# wherever both backends pass the CRC; and identical hard-decision
# decodes on every candidate whose chip signs and counter agree, so each
# differing decision is traced to a sign-flipped chip.  Its element and
# crc_ok agreement are reported.
CHIP_ATOL_REL = 1e-3
LLR_ATOL = 5e-2


class Report:
    """Prints phase lines; every number line names the card."""

    def __init__(self, card: str) -> None:
        self.card = card

    def line(self, phase: str, text: str) -> None:
        print(f"[{phase}] {text}", flush=True)

    def num(self, phase: str, text: str) -> None:
        print(f"[{phase}] {text}  ({self.card})", flush=True)


def _sync(tree):
    return jax.block_until_ready(tree)


@functools.partial(jax.jit, static_argnames=("width",))
def _cut_clips(stream, starts, scale, width: int):
    """(len(starts), width) clips cut from one device-resident stream."""
    from echoseal_tpu.ops.demod import slice_windows

    clips = slice_windows(stream, starts, T) * scale
    return jnp.pad(clips, ((0, 0), (0, width - T)))


def compat_clips(b: int, rng: np.random.Generator) -> jnp.ndarray:
    """(b, T + PAD_COMPAT) silence-host compat clips, staged on device."""
    from echoseal_tpu.models.embedder import BatchEmbedder

    be = BatchEmbedder(KEY)
    total, chunk = 4096, 1024
    stream = jnp.concatenate([
        be.frames_device(np.arange(c0, c0 + chunk), session_nonce=bytes(8))
        for c0 in range(0, total, chunk)]).reshape(-1)
    n_frames = -(-T // FRAME_LEN)
    starts = rng.integers(0, total - n_frames, size=b) * FRAME_LEN
    scale = 10.0 ** (be.p.floor_rel_dbfs / 20.0)
    return _cut_clips(stream, jnp.asarray(starts, jnp.int32), scale,
                      width=T + PAD_COMPAT)


def v2_stream(seconds: float = 12.0) -> np.ndarray:
    """Tone host (700 Hz, 0.15) watermarked by the v2 TX on the host."""
    from echoseal_tpu.models.robust import RobustEmbedder

    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(int(seconds * FS))
                          / FS)).astype(np.float32)
    return RobustEmbedder(KEY).process(host)


def v2_clips(stream: np.ndarray, b: int,
             rng: np.random.Generator) -> jnp.ndarray:
    starts = rng.integers(0, stream.size - T, size=b)
    return _cut_clips(jnp.asarray(stream), jnp.asarray(starts, jnp.int32),
                      1.0, width=T + PAD_V2)


def impaired_clips(stream: np.ndarray, n: int, rng: np.random.Generator):
    """MP3-like codec then +3% playback speed: the SCL and recovery rungs."""
    from echoseal_tpu.utils import channels

    clips = np.zeros((n, T + PAD_V2), np.float32)
    nv = np.zeros(n, np.int32)
    for i, s in enumerate(rng.integers(0, stream.size - T, size=n)):
        y = channels.time_scale(channels.codec_sim(stream[s:s + T]), 1.03)
        clips[i, :y.size] = y
        nv[i] = y.size
    return clips, nv


# ---------------------------------------------------------------- phases
def phase_compat(rep: Report, b: int, rng: np.random.Generator):
    from echoseal_tpu.models.pipeline import BatchVerifier

    t0 = time.perf_counter()
    clips = _sync(compat_clips(b, rng))
    rep.num("compat", f"clip staging (device TX) {time.perf_counter() - t0:.3f} s")
    nv = jnp.full(b, T, jnp.int32)

    t0 = time.perf_counter()
    bv = BatchVerifier(KEY)
    _sync(bv._pn_table)
    rep.num("setup", f"compat table build {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    out = _sync(bv.run_device(clips, nv))
    rep.num("setup", f"compat stage cold (compile + first run) B={b} "
            f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    bv.finish_host(out)
    rep.num("compat", f"host AEAD finish for {b} clips "
            f"{time.perf_counter() - t0:.4f} s")

    t0 = time.perf_counter()
    verdicts = bv.finish_host(bv.run_device(clips, nv))
    dt = time.perf_counter() - t0
    acc = float(np.mean(verdicts))
    rep.num("compat", f"steady run_device+finish_host B={b} {dt:.4f} s "
            f"({b * CLIP_S / dt:.1f} audio-s/s), accept {acc:.3f}")
    if acc != 1.0:
        raise AssertionError(f"compat accept {acc} != 1.000")

    wrong = BatchVerifier(WRONG_KEY)
    acc_w = float(np.mean(wrong.finish_host(wrong.run_device(clips, nv))))
    rep.line("compat", f"wrong key accept {acc_w:.3f}")
    if acc_w != 0.0:
        raise AssertionError(f"compat wrong-key accept {acc_w} != 0.000")
    return bv, clips


def phase_v2(rep: Report, b: int, n_impaired: int,
             rng: np.random.Generator):
    from echoseal_tpu.models.pipeline import RobustBatchVerifier

    t0 = time.perf_counter()
    stream = v2_stream()
    clips = _sync(v2_clips(stream, b, rng))
    rep.num("v2", f"clip staging (host TX) {time.perf_counter() - t0:.3f} s")
    nv = np.full(b, T, np.int32)

    t0 = time.perf_counter()
    bv2 = RobustBatchVerifier(KEY)
    _sync(bv2._m_stack)
    rep.num("setup", f"v2 table build ({bv2._m_stack.nbytes / 1e6:.0f} MB "
            f"{bv2._m_stack.dtype} LS tables) {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    bv2.verify_batch(clips, nv)
    rep.num("setup", f"v2 verify_batch cold (compile + first run) B={b} "
            f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    verdicts = bv2.verify_batch(clips, nv)
    dt = time.perf_counter() - t0
    acc = float(np.mean(verdicts))
    rep.num("v2", f"steady verify_batch B={b} {dt:.4f} s "
            f"({b * CLIP_S / dt:.1f} audio-s/s), accept {acc:.3f}")
    if acc != 1.0:
        raise AssertionError(f"v2 accept {acc} != 1.000")

    t0 = time.perf_counter()
    wrong = RobustBatchVerifier(WRONG_KEY)
    acc_w = float(np.mean(wrong.verify_batch(clips, nv)))
    rep.num("v2", f"wrong key accept {acc_w:.3f} "
            f"(incl. table build) {time.perf_counter() - t0:.3f} s")
    if acc_w != 0.0:
        raise AssertionError(f"v2 wrong-key accept {acc_w} != 0.000")

    imp, nv_imp = impaired_clips(stream, n_impaired, rng)
    t0 = time.perf_counter()
    v_imp = bv2.verify_batch_recover(imp, nv_imp)
    rep.num("v2", f"impaired (codec_sim + time_scale 1.03) "
            f"verify_batch_recover B={n_impaired}, cold "
            f"{time.perf_counter() - t0:.3f} s, accept {np.mean(v_imp):.3f}")
    return bv2, clips


def phase_cli(rep: Report) -> None:
    from echoseal_tpu.cli import rx_app, tx_app
    from echoseal_tpu.io import wavio

    t = np.arange(4 * FS) / FS
    hosts = {"compat": np.zeros(t.size, np.float32),
             "v2": (0.15 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)}
    with tempfile.TemporaryDirectory() as d:
        for profile, host in hosts.items():
            t0 = time.perf_counter()
            host_path = os.path.join(d, f"host_{profile}.wav")
            wavio.write(host_path, host, FS)
            outs = []
            for i in range(4):
                outs.append(os.path.join(d, f"{profile}_{i}.wav"))
                rc = tx_app.main(["--key", KEY.hex(), "--profile", profile,
                                  "--infile", host_path,
                                  "--outfile", outs[-1]])
                if rc != 0:
                    raise AssertionError(f"echoseal-tx {profile} rc={rc}")
            rc = rx_app.main(["--key", KEY.hex(), "--profile", profile,
                              "--batch", "--audio", *outs])
            if rc != 0:
                raise AssertionError(f"echoseal-rx --batch {profile} rc={rc}")
            rep.num("cli", f"{profile}: tx x4 + rx --batch authentic, "
                    f"{time.perf_counter() - t0:.3f} s (cold)")


@functools.partial(jax.jit, static_argnames=("spec",))
def _llr_hard(chips, ctr, pn_table, spec):
    """Payload LLRs and hard-decision decode from a stage's chip outputs."""
    from echoseal_tpu.ops import demod
    from echoseal_tpu.ops.polar import hard_decode_batch

    pn_sy = 2.0 * pn_table[ctr].astype(jnp.float32) - 1.0
    llr = demod.payload_llr(chips, pn_sy)
    info, crc_ok = hard_decode_batch(llr, spec)
    return llr, info, crc_ok


def _compare_stage(rep: Report, name: str, spec, pn_table, g, c,
                   peak_axis_expand, elementwise: bool) -> None:
    """Hold GPU outputs ``g`` to CPU outputs ``c`` on matching candidates.

    A candidate row is compared where both backends found the same sync
    peak; a different peak order (a near-tie ranked differently) is a
    different candidate, not a numerical error, and is counted.  With
    ``elementwise`` the chips and LLRs must also agree to the tolerances
    above, and crc_ok everywhere (see there for why compat is exempt).
    """
    same = np.asarray(g["peak_idx"]) == np.asarray(c["peak_idx"])
    same = peak_axis_expand(same)
    hg = jax.device_get(_llr_hard(g["chips"], g["ctr"], pn_table, spec))
    cpu_tab = jax.device_put(pn_table, jax.devices("cpu")[0])
    hc = jax.device_get(_llr_hard(c["chips"], c["ctr"], cpu_tab, spec))
    chips_g, chips_c = np.asarray(g["chips"]), np.asarray(c["chips"])
    m = np.broadcast_to(same, chips_g.shape[:-1])
    cg, cc = chips_g[m], chips_c[m]
    rms = float(np.sqrt(np.mean(cc ** 2)))
    close = np.abs(cg - cc) <= CHIP_ATOL_REL * rms
    # a candidate's LLRs despread with the PN of its resolved counter, so
    # they are compared where both backends also resolved the same one
    m_ctr = m & (np.asarray(g["ctr"]) == np.asarray(c["ctr"]))
    llr_close = np.abs(hg[0][m_ctr] - hc[0][m_ctr]) <= LLR_ATOL
    sign = np.sign(cg) == np.sign(cc)
    crc_g, crc_c = np.asarray(g["crc_ok"])[m], np.asarray(c["crc_ok"])[m]
    both = crc_g & crc_c
    rep.line("numerics", (
        f"{name}: {m.mean():.3f} of {m.size} candidates share a peak; chips "
        f"within {CHIP_ATOL_REL:g} x rms {close.mean():.6f}, sign-equal "
        f"{sign.mean():.6f}, rows with any chip outside "
        f"{int((~close).any(-1).sum())}/{close.shape[0]}; counters equal "
        f"{m_ctr.sum() / m.sum():.4f}, LLRs within "
        f"{LLR_ATOL:g} {llr_close.mean():.6f}; stage crc_ok equal "
        f"{(crc_g == crc_c).mean():.4f} ({int(crc_g.sum())} GPU / "
        f"{int(crc_c.sum())} CPU pass); hard bits equal on "
        f"{int(both.sum())} CRC-passing rows "
        f"{bool(np.array_equal(hg[1][m][both], hc[1][m][both]))}"))
    # the hard decode is a function of the LLR signs and the counter
    # alone: candidates that agree on both must decode identically
    agree = sign.all(-1) & m_ctr[m]
    rep.line("numerics", (
        f"{name}: {int((crc_g != crc_c).sum())} candidates differ in "
        f"crc_ok, {int(((crc_g != crc_c) & agree).sum())} of them with "
        f"equal chip signs and counter"))
    if elementwise and not (close.all() and llr_close.all()):
        raise AssertionError(f"{name} chips/LLRs outside tolerance")
    if elementwise and not np.array_equal(crc_g, crc_c):
        raise AssertionError(f"{name}: crc_ok differs GPU vs CPU")
    if not (np.array_equal(hg[2][m][agree], hc[2][m][agree])
            and np.array_equal(hg[1][m][agree], hc[1][m][agree])):
        raise AssertionError(f"{name}: equal chip signs decoded differently")
    if not np.array_equal(hg[1][m][both], hc[1][m][both]):
        raise AssertionError(f"{name} hard bits differ GPU vs CPU")


def phase_numerics(rep: Report, bv, clips_c, bv2, clips_v2,
                   n: int, rng: np.random.Generator) -> None:
    from echoseal_tpu.models.pipeline import (
        _batch_verify_stage,
        _batch_verify_stage_v2,
    )
    from echoseal_tpu.ops.polar import encode_np, polar_spec
    from echoseal_tpu.ops.scl import _scl_decode_dense, scl_decode

    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    nv = jnp.full(n, T, jnp.int32)

    args = (clips_c[:n], nv, bv._templates, bv._m_direct, bv._t_fwd,
            bv._pre_sy, bv._hdr_pn_sy, bv._pn_table, bv._hop_table)
    g = _sync(_batch_verify_stage(*args, peaks=bv.peaks))
    c = _sync(_batch_verify_stage(*jax.device_put(args, cpu), peaks=bv.peaks))
    _compare_stage(rep, "compat", bv._spec, bv._pn_table, g, c,
                   lambda s: s, elementwise=False)
    vg, vc = bv.finish_host(g), bv.finish_host(c)
    if not np.array_equal(vg, vc) or not vg.all():
        raise AssertionError(f"compat verdicts GPU {vg} vs CPU {vc}")

    args2 = (clips_v2[:n], nv, bv2._templates, bv2._m_stack, bv2._pre_sy,
             bv2._hdr_pn_sy, bv2._pn_table, bv2._hop_table)
    kw = dict(peaks=bv2.peaks, span=bv2.span, spec=bv2._spec,
              sync_dtype=bv2._sync_dtype)
    g2 = _sync(_batch_verify_stage_v2(*args2, **kw))
    c2 = _sync(_batch_verify_stage_v2(*jax.device_put(args2, cpu), **kw))
    _compare_stage(rep, "v2", bv2._spec, bv2._pn_table, g2, c2,
                   lambda s: s[:, :, None, :], elementwise=True)
    vg2 = bv2._finish_ladder(g2, None, True, 1 << 20)
    vc2 = bv2._finish_ladder(c2, None, True, 1 << 20)
    if not np.array_equal(vg2, vc2) or not vg2.all():
        raise AssertionError(f"v2 verdicts GPU {vg2} vs CPU {vc2}")
    rep.line("numerics", f"verdicts identical GPU vs CPU on {n} compat "
             f"+ {n} v2 clips")

    # SCL: production default vs the dense oracle, L=256, 16 noisy rows
    spec = polar_spec()
    bits = np.stack([encode_np(rng.bytes(55), spec) for _ in range(16)])
    sigma = 0.55
    y = (2.0 * bits - 1.0) + sigma * rng.standard_normal(bits.shape)
    llr = jnp.asarray((2.0 * y / sigma ** 2).astype(np.float32))
    a = jax.device_get(scl_decode(llr, spec, 256))
    d = jax.device_get(_scl_decode_dense(llr, spec, 256))
    n_ok = 0
    for r in range(16):
        sa = {a["info_bits"][r, i].tobytes()
              for i in np.flatnonzero(a["crc_ok"][r])}
        sd = {d["info_bits"][r, i].tobytes()
              for i in np.flatnonzero(d["crc_ok"][r])}
        if sa != sd:
            raise AssertionError(f"SCL row {r}: CRC-passing paths differ "
                                 "from the dense oracle")
        n_ok += bool(sa)
    rep.num("numerics", f"SCL L=256 default vs dense oracle: CRC-passing "
            f"path sets identical on 16 rows ({n_ok} decodable); phase "
            f"{time.perf_counter() - t0:.3f} s")


def phase_memory(rep: Report, bv2, clips_v2, cache_dir: str,
                 entries_before: int) -> None:
    from echoseal_tpu.models.pipeline import _batch_verify_stage_v2

    b = clips_v2.shape[0]
    compiled = _batch_verify_stage_v2.lower(
        clips_v2, jnp.full(b, T, jnp.int32), bv2._templates, bv2._m_stack,
        bv2._pre_sy, bv2._hdr_pn_sy, bv2._pn_table, bv2._hop_table,
        peaks=bv2.peaks, span=bv2.span, spec=bv2._spec,
        sync_dtype=bv2._sync_dtype).compile()
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    rep.num("memory", f"v2 stage B={b} memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(ma, f, None)}"
        for f in fields))
    stats = jax.devices()[0].memory_stats() or {}
    rep.num("memory", f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}"
            f" of bytes_limit {stats.get('bytes_limit')}")
    rep.line("cache", f"compile cache {cache_dir}: {entries_before} entries "
             f"before, {_count_entries(cache_dir)} after")


def _count_entries(path: str) -> int:
    return sum(len(files) for _, _, files in os.walk(path))


def phase_four(rep: Report) -> None:
    """Sharded streams mesh on 4 GPUs vs the same clips on one device."""
    from echoseal_tpu.models.pipeline import BatchVerifier, RobustBatchVerifier
    from echoseal_tpu.parallel import dryrun

    t0 = time.perf_counter()
    res = dryrun.run(4)
    rep.num("four", f"dryrun.run(4) sharded TX/verify/v2/recovery "
            f"{time.perf_counter() - t0:.3f} s (cold)")
    nonce = res["nonce"]
    bv = BatchVerifier(KEY, max_ctr=64)
    single = bv.finish_host(bv.run_device(*res["compat"]["inputs"]),
                            expected_nonce=nonce)
    bv2 = RobustBatchVerifier(KEY, max_ctr=64)
    single2 = bv2._finish_ladder(bv2.run_device(*res["v2"]["inputs"]),
                                 nonce, True, 1 << 20)
    for name, one, sharded in (("compat", single, res["compat"]["verdicts"]),
                               ("v2", single2, res["v2"]["verdicts"])):
        if not np.array_equal(one, sharded):
            raise AssertionError(f"{name}: sharded verdicts {sharded} != "
                                 f"single-device {one}")
        rep.line("four", f"{name}: sharded verdicts {sharded.astype(int)} "
                 f"== single-device {one.astype(int)}")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded streams-mesh phase")
    args = ap.parse_args(argv)

    info = gpu_info()
    card = "; ".join(info["cards"])
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    print(card, flush=True)
    rep = Report(card)

    from echoseal_tpu.utils.cache import enable_persistent_cache

    cache_dir = enable_persistent_cache()
    entries_before = _count_entries(cache_dir)

    want = 4 if args.four else 1
    if info["count"] != want:
        raise RuntimeError(f"expected {want} GPU(s), JAX sees "
                           f"{info['count']}")
    t_start = time.perf_counter()
    if args.four:
        phase_four(rep)
    else:
        rng = np.random.default_rng(SEED)
        bv, clips_c = phase_compat(rep, B, rng)
        bv2, clips_v2 = phase_v2(rep, B, N_IMPAIRED, rng)
        phase_cli(rep)
        phase_numerics(rep, bv, clips_c, bv2, clips_v2, N_NUMERICS, rng)
        phase_memory(rep, bv2, clips_v2, cache_dir, entries_before)
    rep.num("total", f"wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
