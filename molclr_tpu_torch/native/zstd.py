"""ctypes bindings for the Zstandard decoder and CRC-32C of zstd.cpp.

The JAX package's Orbax checkpoints are zstd-compressed throughout (every
OCDBT node and every zarr chunk), and the card's machine has no zstd
package, so the port decodes them itself: zstd.cpp is a frame decoder
written to RFC 8878, built with g++ at first use into build/native/ as
the featurizer is (a failed build raises).
"""

from __future__ import annotations

import ctypes
import threading

from molclr_tpu_torch import native

SRC = native.SRC.parent / "zstd.cpp"

# mtpu_zstd_decompress's code for an output larger than its capacity
CAPACITY_EXCEEDED = -4

_lock = threading.Lock()
_lib = None


class ZstdError(ValueError):
    """A zstd frame that the decoder could not account for."""


def _load():
    global _lib
    with _lock:
        if _lib is None:
            native.build(SRC)
            lib = ctypes.CDLL(str(native.lib_path(SRC)))
            i64, buf = ctypes.c_int64, ctypes.c_char_p
            lib.mtpu_zstd_content_size.restype = i64
            lib.mtpu_zstd_content_size.argtypes = [buf, i64]
            lib.mtpu_zstd_decompress.restype = i64
            lib.mtpu_zstd_decompress.argtypes = [buf, i64, ctypes.c_void_p,
                                                 i64]
            lib.mtpu_zstd_error.restype = ctypes.c_char_p
            lib.mtpu_crc32c.restype = ctypes.c_uint32
            lib.mtpu_crc32c.argtypes = [buf, i64]
            _lib = lib
        return _lib


def decompress(data: bytes, size: int | None = None) -> bytes:
    """The bytes of the zstd frames in `data`, one after another. `size`,
    where given, is the decompressed size that the caller expects (a zarr
    chunk's, from its array's shape); a frame that does not state its
    size is otherwise decoded into a buffer that grows until it fits."""
    lib = _load()
    stated = lib.mtpu_zstd_content_size(data, len(data))
    if stated < -1:
        raise ZstdError(lib.mtpu_zstd_error().decode())
    cap = stated if stated >= 0 else (size if size is not None
                                      else 4 * len(data) + 1024)
    while True:
        out = ctypes.create_string_buffer(max(1, cap))
        got = lib.mtpu_zstd_decompress(data, len(data), out, cap)
        if got != CAPACITY_EXCEEDED or stated >= 0 or size is not None:
            break
        cap *= 4
    if got < 0:
        raise ZstdError(lib.mtpu_zstd_error().decode())
    if size is not None and got != size:
        raise ZstdError(f"decompressed {got} bytes where {size} were "
                        f"expected")
    return out.raw[:got]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`, as OCDBT files end with."""
    return int(_load().mtpu_crc32c(data, len(data)))
