"""Native (C) runtime tier: lock-free real-time mixer.

The accelerator owns the batch compute path; the native tier owns the
latency-critical host runtime around it -- here, the audio-callback mixer
(a lock-free SPSC chip ring written in C, see mixer.c) so the PortAudio
thread never touches Python allocation or the GIL-heavy NumPy dispatch.

Built on demand with the system compiler; everything degrades gracefully
to the pure-Python mixer when no compiler is present.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_SRC = _DIR / "mixer.c"
_lock = threading.Lock()
_lib = None


def _so_path() -> Path:
    # Keyed on the SOURCE CONTENT hash (not mtimes, which are arbitrary
    # after a fresh clone), so editing mixer.c always rebuilds and a binary
    # built from different source is never picked up.  Computed lazily:
    # importing this module must not touch the filesystem (load() wraps all
    # failures, keeping available() a clean False when mixer.c is absent).
    return _DIR / f"_mixer-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    subprocess.run(
        ["cc", "-O2", "-shared", "-fPIC", str(_SRC), "-o", str(so), "-lm"],
        check=True, capture_output=True)
    for stale in _DIR.glob("_mixer-*.so"):     # drop superseded builds
        if stale != so:
            stale.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native mixer library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # stale/foreign-arch binary: rebuild once and retry
            _build(so)
            lib = ctypes.CDLL(str(so))
        lib.mixer_new.restype = ctypes.c_void_p
        lib.mixer_new.argtypes = [ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_size_t]
        lib.mixer_free.argtypes = [ctypes.c_void_p]
        lib.mixer_available.restype = ctypes.c_size_t
        lib.mixer_available.argtypes = [ctypes.c_void_p]
        lib.mixer_space.restype = ctypes.c_size_t
        lib.mixer_space.argtypes = [ctypes.c_void_p]
        lib.mixer_push_chips.restype = ctypes.c_size_t
        lib.mixer_push_chips.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        lib.mixer_process.restype = ctypes.c_size_t
        lib.mixer_process.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


class NativeMixer:
    """SPSC chip-ring mixer; feed chips from any thread, mix in the
    audio callback without touching Python object allocation."""

    def __init__(self, *, target_rel_db: float = -10.0,
                 floor_rel_dbfs: float = -35.0, headroom: float = 0.98,
                 capacity_pow2: int = 18) -> None:
        self._lib = load()
        self._h = self._lib.mixer_new(target_rel_db, floor_rel_dbfs,
                                      headroom, capacity_pow2)
        if not self._h:
            raise MemoryError("mixer_new failed")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.mixer_free(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def available_chips(self) -> int:
        return int(self._lib.mixer_available(self._h))

    @property
    def space(self) -> int:
        return int(self._lib.mixer_space(self._h))

    def push_chips(self, chips: np.ndarray) -> int:
        c = np.ascontiguousarray(chips, dtype=np.float32)
        return int(self._lib.mixer_push_chips(
            self._h, c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            c.size))

    def process(self, block: np.ndarray) -> tuple[np.ndarray, int]:
        """Mix one audio block; returns (out, chips_consumed)."""
        x = np.ascontiguousarray(block, dtype=np.float32)
        out = np.empty_like(x)
        used = self._lib.mixer_process(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
        return out, int(used)
