"""EchoSeal: real-time ultrasonic audio watermarking, batched JAX RX.

A from-scratch JAX/XLA rebuild of the EchoSeal capability surface
(reference: PetarSt98/EchoSeal): a transmitter mixes an AES-encrypted,
polar-coded fingerprint into live audio across four keyed ultrasonic hop
bands; a receiver proves authenticity of a >=3 s recording.

Public surface (parity with reference rtwm/__init__.py:9-12, plus the
batch/serving tier):

    WatermarkEmbedder  -- streaming TX mixer (sample-exact wire format)
    WatermarkDetector  -- single-clip verifier with the full fallback ladder
    BatchEmbedder      -- bulk TX, one device program for many frames
    BatchVerifier      -- multi-clip verification, one device program
    SecureChannel      -- HKDF/AEAD/PN crypto core (host-side)
    TxParams, RxParams -- configuration dataclasses
"""
from echoseal_tpu.core.crypto import SecureChannel
from echoseal_tpu.core.params import RxParams, TxParams
from echoseal_tpu.models.detector import WatermarkDetector
from echoseal_tpu.models.embedder import BatchEmbedder, WatermarkEmbedder
from echoseal_tpu.models.pipeline import BatchVerifier

__version__ = "0.1.0"

__all__ = [
    "WatermarkEmbedder",
    "WatermarkDetector",
    "BatchEmbedder",
    "BatchVerifier",
    "SecureChannel",
    "TxParams",
    "RxParams",
    "__version__",
]
