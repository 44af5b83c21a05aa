"""Error taxonomy for the DEFLATE framework.

Mirrors the complete 19-value ``Reason`` enum of the reference library
(``/root/reference/src/io/nayuki/deflate/DataFormatException.java:61-83``):
12 raw-DEFLATE reasons, 4 container reasons, and 3 gzip-header reasons.

Every decode-side failure in this framework — whether raised by the host
state machine or surfaced as an integer error code from a jitted device kernel
— maps onto exactly one of these reasons, so callers can switch on
``DataFormatError.reason`` the same way reference users switch on
``DataFormatException.getReason()``.
"""

from __future__ import annotations

import enum


class Reason(enum.IntEnum):
    """Why a DEFLATE/gzip/zlib stream was rejected.

    The integer values double as device-side error codes: device kernels
    report failures as ``int32`` lanes holding ``reason + 1`` (0 = ok),
    which the host converts back through ``Reason(code - 1)``.
    """

    # --- raw DEFLATE (RFC 1951) ---
    UNEXPECTED_END_OF_STREAM = 0
    RESERVED_BLOCK_TYPE = 1
    UNCOMPRESSED_BLOCK_LENGTH_MISMATCH = 2
    HUFFMAN_CODE_UNDER_FULL = 3
    HUFFMAN_CODE_OVER_FULL = 4
    NO_PREVIOUS_CODE_LENGTH_TO_COPY = 5
    CODE_LENGTH_CODE_OVER_FULL = 6
    END_OF_BLOCK_CODE_ZERO_LENGTH = 7
    RESERVED_LENGTH_SYMBOL = 8
    RESERVED_DISTANCE_SYMBOL = 9
    LENGTH_ENCOUNTERED_WITH_EMPTY_DISTANCE_CODE = 10
    COPY_FROM_BEFORE_DICTIONARY_START = 11

    # --- containers (RFC 1950 / RFC 1952 shared) ---
    HEADER_CHECKSUM_MISMATCH = 12
    UNSUPPORTED_COMPRESSION_METHOD = 13
    DECOMPRESSED_CHECKSUM_MISMATCH = 14
    DECOMPRESSED_SIZE_MISMATCH = 15

    # --- gzip header (RFC 1952) ---
    GZIP_INVALID_MAGIC_NUMBER = 16
    GZIP_RESERVED_FLAGS_SET = 17
    GZIP_UNSUPPORTED_OPERATING_SYSTEM = 18


class DataFormatError(ValueError):
    """Raised when a stream violates RFC 1951/1950/1952.

    Analog of the reference's unchecked ``DataFormatException``
    (``DataFormatException.java:15-55``): carries a mandatory ``Reason``
    plus a human-readable message.
    """

    def __init__(self, reason: Reason, message: str):
        super().__init__(message)
        self.reason = Reason(reason)

    @staticmethod
    def unexpected_end() -> "DataFormatError":
        """Shorthand for the most common failure (truncated input)."""
        return DataFormatError(Reason.UNEXPECTED_END_OF_STREAM, "Unexpected end of stream")


def raise_unexpected_end():
    raise DataFormatError.unexpected_end()


class OutputCapacityError(RuntimeError):
    """A native decode needs a larger output buffer (internal signal).

    Deliberately NOT a subclass of ``ValueError``/``DataFormatError``:
    grow-and-retry loops must catch exactly this and let real format
    errors propagate (a corrupt stream must never be retried with a
    bigger buffer).
    """


# Device-side encoding helpers -------------------------------------------------

OK_CODE = 0  #: kernel error-lane value meaning "no error"


def reason_to_code(reason: Reason) -> int:
    """Map a Reason to the nonzero int32 code kernels report."""
    return int(reason) + 1


def code_to_reason(code: int) -> Reason:
    """Inverse of :func:`reason_to_code` (code must be nonzero)."""
    if code == OK_CODE:
        raise ValueError("code 0 means success, not an error")
    return Reason(code - 1)


def check_device_error(code: int, context: str = "") -> None:
    """Raise DataFormatError if a kernel-reported error code is set."""
    code = int(code)
    if code != OK_CODE:
        reason = code_to_reason(code)
        suffix = f" ({context})" if context else ""
        raise DataFormatError(reason, f"{reason.name}{suffix}")
