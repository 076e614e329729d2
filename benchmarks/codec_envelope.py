"""Measured v2 + compat envelope through REAL codecs.

The reference claims MP3-128k survival but ships no codec test
(reference README.md:163; SURVEY.md §6).  This script measures
single-clip accept rates through actual encode->decode round-trips and
writes ``codec_envelope.json``, the artifact behind
tests/test_codecs.py's pinned verdicts.  Codec classes:

* G.711 mu-law / A-law (8-bit logarithmic companding, the telephony/
  VoIP trunk codecs) and IMA ADPCM (4-bit adaptive differential) via
  stdlib ``audioop``;
* MPEG-1 Audio Layer II at 64/128/192 kbps via the in-repo codec
  (utils/mpeg1.py: 32-band polyphase + psychoacoustic bit allocation +
  serialized bitstream) -- the REAL perceptual-transform class behind
  the reference's MP3 claim, replacing the round-3 windowed-DFT
  simulation row;
* a real third-party rate converter (``audioop.ratecv``).

Usage: python benchmarks/codec_envelope.py [--out FILE] [--platform cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmarks/codec_envelope.json")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    ap.add_argument("--draws", type=int, default=4,
                    help="independent (nonce, excerpt) draws per row")
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

    from echoseal_tpu.models.detector import WatermarkDetector
    from echoseal_tpu.models.embedder import BatchEmbedder
    from echoseal_tpu.models.robust import RobustEmbedder, RobustVerifier
    from echoseal_tpu.utils import channels

    key = bytes.fromhex("aa" * 32)
    wrong = bytes.fromhex("55" * 32)
    fs = 48_000
    T = int(4 * fs)
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T + 2 * fs) / fs)
            ).astype(np.float32)

    codecs = {
        "ulaw": channels.codec_ulaw,
        "alaw": channels.codec_alaw,
        "adpcm": channels.codec_adpcm,
        # REAL perceptual transform codec (in-repo MPEG-1 Layer II,
        # utils/mpeg1.py): the claim class the reference names
        "mpeg1_l2@128k": lambda x: channels.codec_mpeg1_l2(x, 128),
        "mpeg1_l2@192k": lambda x: channels.codec_mpeg1_l2(x, 192),
        "mpeg1_l2@64k": lambda x: channels.codec_mpeg1_l2(x, 64),
        # REAL MPEG-1 Layer III (utils/mpeg1_l3.py: MDCT + alias
        # reduction + Huffman + bit reservoir): the LITERAL "MP3
        # 128 kbps" claim (VERDICT r4 next #2)
        "mpeg1_l3@128k": lambda x: channels.codec_mpeg1_l3(x, 128),
        "mpeg1_l3@192k": lambda x: channels.codec_mpeg1_l3(x, 192),
        "mpeg1_l3@64k": lambda x: channels.codec_mpeg1_l3(x, 64),
    }

    def sweep(make_clip, verify, label):
        rows = {}
        for name, fn in codecs.items():
            acc, wrong_acc = [], []
            for k in range(args.draws):
                clip = make_clip(k)
                y = np.ascontiguousarray(fn(clip))
                acc.append(bool(verify(key, y)))
                wrong_acc.append(bool(verify(wrong, y)))
            rows[name] = {"accept": sum(acc) / len(acc),
                          "wrong_key_accept": sum(wrong_acc) / len(acc)}
            print(f"{label}/{name}: {rows[name]}", flush=True)
        return rows

    # ---- v2 (robust) profile: the analog-impairment carrier -------------
    def v2_clip(k):
        tx = RobustEmbedder(key)
        tx._session_nonce = bytes([0x40 + k]) * 8
        wm = tx.process(host)
        s = int(np.random.default_rng(k).integers(0, wm.size - T))
        return wm[s : s + T]

    def v2_verify(k32, y):
        return RobustVerifier(k32).verify(y, fs)

    v2_rows = sweep(v2_clip, v2_verify, "v2")

    # ---- v2 under a SPEECH host (VERDICT r4 next #3) --------------------
    # The reference's core use case is live speech; the surrogate host
    # (utils/channels.speech_host) is wideband and syllabically
    # nonstationary -- the hard host class for a perceptual codec, which
    # shapes its quantisation noise to hide under exactly this spectrum.
    speech = channels.speech_host(T / fs + 2.0, fs,
                                  rng=np.random.default_rng(123))

    def v2_speech_clip(k):
        # block-wise embed: the live TX path's per-block level tracking
        # (the representative behavior for a syllabic host)
        tx = RobustEmbedder(key)
        tx._session_nonce = bytes([0x50 + k]) * 8
        wm = np.concatenate([tx.process(speech[i: i + 1024])
                             for i in range(0, speech.size, 1024)])
        s = int(np.random.default_rng(30 + k).integers(0, wm.size - T))
        return wm[s : s + T]

    v2_speech_rows = sweep(v2_speech_clip, v2_verify, "v2_speech")

    # real rate converter: 48 kHz playback captured by a 44.1 kHz clock
    # (audioop.ratecv linear interpolation, NOT our polyphase resampler)
    acc, wrong_acc = [], []
    for k in range(args.draws):
        y = channels.codec_ratecv(v2_clip(k), fs, 44_100)
        acc.append(bool(RobustVerifier(key).verify(y, 44_100)))
        wrong_acc.append(bool(RobustVerifier(wrong).verify(y, 44_100)))
    v2_rows["ratecv_44k1_capture"] = {
        "accept": sum(acc) / len(acc),
        "wrong_key_accept": sum(wrong_acc) / len(acc)}
    print(f"v2/ratecv_44k1_capture: {v2_rows['ratecv_44k1_capture']}")

    # ---- compat profile: digitally-clean carrier through 8-bit trunks ---
    def compat_clip(k):
        be = BatchEmbedder(key)
        wm = be.embed(np.zeros(T + 2 * fs, dtype=np.float32),
                      session_nonce=bytes([0x60 + k]) * 8)
        s = int(np.random.default_rng(50 + k).integers(0, wm.size - T))
        return wm[s : s + T]

    def compat_verify(k32, y):
        return WatermarkDetector(k32, list_size=16).verify(y, fs)

    compat_rows = sweep(compat_clip, compat_verify, "compat")

    report = {"platform": jax.default_backend(),
              "draws": args.draws, "clip_s": T / fs,
              "v2_host": "700 Hz tone, watermark ~11x below",
              "v2_speech_host": "formant-synth speech surrogate "
                                "(channels.speech_host, seeded)",
              "compat_host": "silence (floor-level watermark)",
              "v2": v2_rows, "v2_speech": v2_speech_rows,
              "compat": compat_rows}
    out = json.dumps(report, indent=2)
    print(out)
    Path(args.out).write_text(out)


if __name__ == "__main__":
    main()
