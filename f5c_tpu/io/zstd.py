"""zstd frames through the system ``libzstd`` (ctypes, one-shot frame
API)."""

from __future__ import annotations

import ctypes
import ctypes.util

_LIB: list = []
_UNKNOWN = 2**64 - 1          # ZSTD_CONTENTSIZE_UNKNOWN
_ERROR = 2**64 - 2            # ZSTD_CONTENTSIZE_ERROR


def _libzstd():
    if not _LIB:
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise RuntimeError("zstd data needs the system libzstd")
        lib = ctypes.CDLL(name)
        sz, p = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [p, sz]
        lib.ZSTD_decompress.restype = sz
        lib.ZSTD_decompress.argtypes = [p, sz, p, sz]
        lib.ZSTD_compressBound.restype = sz
        lib.ZSTD_compressBound.argtypes = [sz]
        lib.ZSTD_compress.restype = sz
        lib.ZSTD_compress.argtypes = [p, sz, p, sz, ctypes.c_int]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [sz]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [sz]
        _LIB.append(lib)
    return _LIB[0]


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise RuntimeError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(blob: bytes, max_output_size: int = 0) -> bytes:
    """One frame; ``max_output_size`` bounds a frame that does not
    record its content size."""
    lib = _libzstd()
    n = lib.ZSTD_getFrameContentSize(blob, len(blob))
    if n == _ERROR:
        raise RuntimeError("zstd: not a zstd frame")
    if n == _UNKNOWN:
        if not max_output_size:
            raise RuntimeError("zstd: frame without content size")
        n = max_output_size
    out = ctypes.create_string_buffer(max(n, 1))
    got = _check(lib, lib.ZSTD_decompress(out, n, blob, len(blob)))
    return out.raw[:got]


def compress(data: bytes, level: int = 3) -> bytes:
    lib = _libzstd()
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    got = _check(lib, lib.ZSTD_compress(out, cap, data, len(data), level))
    return out.raw[:got]
