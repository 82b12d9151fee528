"""Error types.

Replaces the reference's GError quark + error-code enum
(`src/cl_ops/common/clo_common.in.h:80-95`: CLO_ERROR_OPENFILE, ARGS,
DEVICE_NOT_FOUND, STREAM_WRITE, IMPL_NOT_FOUND, OUT_OF_RESOURCES, LIBRARY,
UNABLE_SAVE) and the goto-based propagation macros
(`src/cl_ops/common/_g_err_macros.h:61-96`) with ordinary exceptions.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    # Parity with clo_error_codes (clo_common.in.h:80-95).
    OPENFILE = 1
    ARGS = 2
    DEVICE_NOT_FOUND = 3
    STREAM_WRITE = 4
    IMPL_NOT_FOUND = 5
    OUT_OF_RESOURCES = 6
    LIBRARY = 7
    UNABLE_SAVE = 8
    # New-framework codes.
    BAD_DTYPE = 100
    BAD_SHAPE = 101
    SHARDING = 102
    IMPL_DUPLICATE = 103


class CloOpsError(Exception):
    """Base exception carrying an ErrorCode (GError analog)."""

    def __init__(self, message: str, code: ErrorCode = ErrorCode.LIBRARY):
        super().__init__(message)
        self.code = code


class BadArgsError(CloOpsError):
    def __init__(self, message: str):
        super().__init__(message, ErrorCode.ARGS)


class BadDtypeError(CloOpsError):
    def __init__(self, message: str):
        super().__init__(message, ErrorCode.BAD_DTYPE)
