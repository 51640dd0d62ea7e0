"""Error surface of the framework.

The reference maps OpenCL status codes to human-readable strings
(``cl_fft.cpp:298-395`` and the duplicate table in ``cl_conv.h:25-122``) and
lets callers poll ``get_error()``/``get_cl_err()``. This framework
raises typed exceptions instead, but we keep:

  * ``Status`` — an integer status enum whose *names* cover the same failure
    classes the reference distinguishes (device lookup, allocation, invalid
    argument, build/compile failure, ...), so code written against
    ``get_error() == 0`` keeps working through the parity classes in
    ``api.py``.
  * ``error_string(code)`` — the ``cl_error_string`` equivalent.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    SUCCESS = 0
    DEVICE_NOT_FOUND = -1
    DEVICE_NOT_AVAILABLE = -2
    COMPILER_NOT_AVAILABLE = -3
    MEM_ALLOCATION_FAILURE = -4
    OUT_OF_RESOURCES = -5
    OUT_OF_HOST_MEMORY = -6
    BUILD_PROGRAM_FAILURE = -11
    INVALID_VALUE = -30
    INVALID_DEVICE = -33
    INVALID_ARG_VALUE = -50
    INVALID_WORK_GROUP_SIZE = -54
    INVALID_BUFFER_SIZE = -61
    UNKNOWN = -9999


_STRINGS = {
    Status.SUCCESS: "Success!",
    Status.DEVICE_NOT_FOUND: "Device not found.",
    Status.DEVICE_NOT_AVAILABLE: "Device not available",
    Status.COMPILER_NOT_AVAILABLE: "Compiler not available",
    Status.MEM_ALLOCATION_FAILURE: "Memory object allocation failure",
    Status.OUT_OF_RESOURCES: "Out of resources",
    Status.OUT_OF_HOST_MEMORY: "Out of host memory",
    Status.BUILD_PROGRAM_FAILURE: "Program build failure",
    Status.INVALID_VALUE: "Invalid value",
    Status.INVALID_DEVICE: "Invalid device",
    Status.INVALID_ARG_VALUE: "Invalid argument value",
    Status.INVALID_WORK_GROUP_SIZE: "Invalid work group size",
    Status.INVALID_BUFFER_SIZE: "Invalid buffer size",
}


def error_string(code: int) -> str:
    """Human-readable message for a status code (cl_error_string parity)."""
    try:
        return _STRINGS.get(Status(code), "Unknown error")
    except ValueError:
        return "Unknown error"


class FftError(RuntimeError):
    """Base exception; carries a Status so get_error() can report it."""

    def __init__(self, message: str, status: Status = Status.UNKNOWN):
        super().__init__(message)
        self.status = Status(status)


class DeviceError(FftError):
    def __init__(self, message: str, status: Status = Status.DEVICE_NOT_FOUND):
        super().__init__(message, status)


class SizeError(FftError):
    def __init__(self, message: str, status: Status = Status.INVALID_BUFFER_SIZE):
        super().__init__(message, status)


class ArgumentError(FftError):
    def __init__(self, message: str, status: Status = Status.INVALID_ARG_VALUE):
        super().__init__(message, status)
