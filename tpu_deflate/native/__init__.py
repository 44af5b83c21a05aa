"""Native host runtime: ctypes bindings for the C codec core.

Builds ``deflate_core.c`` with the system compiler on first use (cached as
a shared object next to the package); every entry point releases the GIL
(plain ctypes foreign calls), so the member-parallel drivers below use a
thread pool to saturate all host cores.

Falls back gracefully: ``available()`` is False when no compiler works,
and all callers route to the pure-Python/NumPy implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "deflate_core.c")
_SO = os.path.join(_HERE, "_deflate_core.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> str | None:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    so = _SO
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O3", "-march=native", "-pthread", "-shared", "-fPIC", "-o", so, src],
                check=True,
                capture_output=True,
            )
            return so
        except (OSError, subprocess.CalledProcessError):
            continue
    return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            _lib = False
            return _lib
        lib = ctypes.CDLL(so)
        lib.td_crc32.restype = ctypes.c_uint32
        lib.td_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
        lib.td_adler32.restype = ctypes.c_uint32
        lib.td_adler32.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
        lib.td_inflate.restype = ctypes.c_int
        lib.td_inflate.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.td_resolve_tokens.restype = ctypes.c_int
        lib.td_resolve_tokens.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.td_deflate_member.restype = ctypes.c_size_t
        lib.td_deflate_member.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.td_deflate_block.restype = ctypes.c_size_t
        lib.td_deflate_block.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_uint,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.td_find_sync.restype = ctypes.c_int64
        lib.td_find_sync.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.td_inflate_marker.restype = ctypes.c_int
        lib.td_inflate_marker.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.td_resolve_markers.restype = ctypes.c_int
        lib.td_resolve_markers.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        lib.td_inflate_members.restype = ctypes.c_int
        lib.td_inflate_members.argtypes = [
            ctypes.c_char_p,                   # data
            ctypes.POINTER(ctypes.c_uint64),   # pay_off
            ctypes.POINTER(ctypes.c_uint64),   # pay_len
            ctypes.POINTER(ctypes.c_uint64),   # out_off (n+1)
            ctypes.POINTER(ctypes.c_uint32),   # want_crc
            ctypes.c_void_p,                   # out
            ctypes.c_long,                     # n members
            ctypes.c_int,                      # n_threads
            ctypes.POINTER(ctypes.c_long),     # err_member
        ]
        lib.td_deflate_members.restype = ctypes.c_size_t
        lib.td_deflate_members.argtypes = [
            ctypes.c_char_p,                   # data
            ctypes.c_size_t,                   # n
            ctypes.c_size_t,                   # member_data
            ctypes.c_int,                      # max_code_len
            ctypes.c_int,                      # max_chain
            ctypes.c_int,                      # n_threads
            ctypes.c_void_p,                   # out
            ctypes.c_size_t,                   # out_cap
        ]
        lib.td_split_members.restype = ctypes.c_long
        lib.td_split_members.argtypes = [
            ctypes.c_char_p,                   # data
            ctypes.c_size_t,                   # len
            ctypes.POINTER(ctypes.c_uint64),   # pay_off
            ctypes.POINTER(ctypes.c_uint64),   # pay_len
            ctypes.POINTER(ctypes.c_uint64),   # isize
            ctypes.POINTER(ctypes.c_uint32),   # crc
            ctypes.c_long,                     # cap
        ]
        lib.td_oracle_tokenize.restype = ctypes.c_size_t
        lib.td_oracle_tokenize.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_uint,
            ctypes.c_uint,
            ctypes.c_uint,
            ctypes.c_uint,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not False


# Uninitialized-bytes allocation via the CPython C API: the caller promises
# to fill every byte before the object escapes. Skips the zero-fill that
# bytes(n)/create_string_buffer would do AND the final buffer->bytes copy.
ctypes.pythonapi.PyBytes_FromStringAndSize.restype = ctypes.py_object
ctypes.pythonapi.PyBytes_FromStringAndSize.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
ctypes.pythonapi.PyBytes_AsString.restype = ctypes.c_void_p
ctypes.pythonapi.PyBytes_AsString.argtypes = [ctypes.py_object]


def _alloc_bytes(n: int) -> bytes:
    if n <= 0:
        return b""
    return ctypes.pythonapi.PyBytes_FromStringAndSize(None, n)


def _bytes_ptr(b: bytes) -> int:
    return ctypes.pythonapi.PyBytes_AsString(b) or 0


# ---------------------------------------------------------------------------
# Thin wrappers
# ---------------------------------------------------------------------------


def crc32(data: bytes, value: int = 0) -> int:
    lib = _load()
    return int(lib.td_crc32(data, len(data), value & 0xFFFFFFFF))


def adler32(data: bytes, value: int = 1) -> int:
    lib = _load()
    return int(lib.td_adler32(data, len(data), value & 0xFFFFFFFF))


def inflate_raw(payload: bytes, out_cap: int) -> tuple[bytes, int]:
    """Decode a complete raw-DEFLATE stream. Returns (bytes, consumed).

    Raises DataFormatError with the taxonomy Reason on malformed input.
    """
    from ..format.errors import OutputCapacityError, check_device_error

    lib = _load()
    out = ctypes.create_string_buffer(out_cap)
    out_len = ctypes.c_size_t(0)
    consumed = ctypes.c_size_t(0)
    rc = lib.td_inflate(
        payload, len(payload), out, out_cap, ctypes.byref(out_len), ctypes.byref(consumed)
    )
    if rc == 100:
        raise OutputCapacityError("output capacity too small")
    check_device_error(rc)
    return out.raw[: out_len.value], consumed.value


def resolve_tokens(tokens: np.ndarray, out_cap: int) -> bytes:
    """Expand a device-decoded token array (int32) to bytes."""
    from ..format.errors import OutputCapacityError, check_device_error

    lib = _load()
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    out = ctypes.create_string_buffer(out_cap)
    out_len = ctypes.c_size_t(0)
    rc = lib.td_resolve_tokens(
        tokens.ctypes.data_as(ctypes.c_void_p), tokens.size, out, out_cap,
        ctypes.byref(out_len),
    )
    if rc == 100:
        raise OutputCapacityError("output capacity too small")
    check_device_error(rc)
    return out.raw[: out_len.value]


def oracle_tokenize(
    buf: np.ndarray,
    hist_len: int,
    *,
    min_run: int,
    max_run: int,
    min_dist: int,
    max_dist: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-semantics greedy tokenizer (exhaustive distance scan,
    smallest-distance tie-break; ≙ comp/Lz77Huffman.java:68-130). The
    ratio-measurement oracle — O(n * max_dist), not a production path.
    Returns (tok_pos, tok_run, tok_dist); tok_run == 0 marks a literal."""
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    m = buf.size - hist_len
    pos = np.empty(max(m, 1), np.int32)
    run = np.empty(max(m, 1), np.int32)
    dist = np.empty(max(m, 1), np.int32)
    ntok = lib.td_oracle_tokenize(
        buf.ctypes.data_as(ctypes.c_char_p), buf.size, hist_len,
        min_run, max_run, min_dist, max_dist,
        pos.ctypes.data_as(ctypes.c_void_p),
        run.ctypes.data_as(ctypes.c_void_p),
        dist.ctypes.data_as(ctypes.c_void_p),
    )
    return pos[:ntok], run[:ntok], dist[:ntok]


def deflate_member_payload(data: bytes, *, max_code_len: int = 12, max_chain: int = 32) -> bytes:
    """Encode <=64 KiB as a single final DEFLATE block (profile payload)."""
    lib = _load()
    cap = len(data) + len(data) // 8 + 1024
    out = ctypes.create_string_buffer(cap)
    n = lib.td_deflate_member(data, len(data), out, cap, max_code_len, max_chain)
    if n == 0 and len(data) > 0:
        raise RuntimeError("native deflate failed")
    return out.raw[:n]


# ---------------------------------------------------------------------------
# Block-parallel foreign-stream decode (rapidgzip-style resync prepass)
# ---------------------------------------------------------------------------


def _find_sync(payload: bytes, from_bit: int, limit_bit: int, min_syms: int = 512) -> int:
    lib = _load()
    return int(lib.td_find_sync(payload, len(payload), from_bit, limit_bit, min_syms))


# Reusable u16 segment buffers: a fresh multi-MB mmap costs ~1 s of
# first-touch page faults on this host, an order of magnitude more than
# the decode itself — so decoded segments borrow from this pool and the
# stitcher returns them after marker resolution.
_MARKER_BUFS: list[np.ndarray] = []
_MARKER_BUFS_LOCK = threading.Lock()


def _take_buf(cap: int) -> np.ndarray:
    with _MARKER_BUFS_LOCK:
        best = None
        for i, b in enumerate(_MARKER_BUFS):
            if b.size >= cap and (best is None or b.size < _MARKER_BUFS[best].size):
                best = i
        if best is not None:
            return _MARKER_BUFS.pop(best)
    return np.empty(max(cap, 1 << 21), dtype=np.uint16)


def _put_buf(buf: np.ndarray) -> None:
    with _MARKER_BUFS_LOCK:
        _MARKER_BUFS.append(buf)
        if len(_MARKER_BUFS) > 8:
            _MARKER_BUFS.pop(0)


def _marker_seg(payload: bytes, start_bit: int, stop_bit: int):
    """Marker-mode decode of [start_bit -> first boundary >= stop_bit).

    Returns (rc, buf, out_len, end_bit, hit_final); the caller owns buf
    (pooled — return it with _put_buf). Grows output on overflow.
    """
    lib = _load()
    approx_in = max((stop_bit - start_bit) // 8, 1)
    cap = max(4 * approx_in, 1 << 20)
    while True:
        buf = _take_buf(cap)
        out_len = ctypes.c_size_t(0)
        end_bit = ctypes.c_int64(0)
        hit_final = ctypes.c_int(0)
        rc = lib.td_inflate_marker(
            payload,
            len(payload),
            start_bit,
            stop_bit,
            0 if start_bit == 0 else 32768,
            buf.ctypes.data_as(ctypes.c_void_p),
            buf.size,
            ctypes.byref(out_len),
            ctypes.byref(end_bit),
            ctypes.byref(hit_final),
        )
        if rc == 100:
            cap = buf.size * 4
            _put_buf(buf)
            continue
        return rc, buf, int(out_len.value), int(end_bit.value), bool(hit_final.value)


def _resolve_markers(seg: np.ndarray, window: bytes) -> bytes | None:
    lib = _load()
    out = ctypes.create_string_buffer(seg.size) if seg.size else ctypes.create_string_buffer(1)
    rc = lib.td_resolve_markers(
        seg.ctypes.data_as(ctypes.c_void_p), seg.size, window, len(window), out
    )
    if rc != 0:
        return None
    return out.raw[: seg.size]


def inflate_raw_parallel(
    payload: bytes, *, workers: int | None = None, min_bytes: int = 4 << 20
) -> tuple[bytes, int] | None:
    """Block-parallel decode of a foreign raw DEFLATE stream.

    The prepass speculatively locates dynamic-block boundaries
    (``td_find_sync``), worker threads decode segments concurrently in
    marker space, and the stitcher adopts a segment only when the serial
    block-boundary chain lands exactly on its start bit — so the result
    is bit-exact no matter how good the speculation was (SURVEY.md §2.1
    "decode-side data parallel"; the seam the reference leaves:
    ``decomp/Open.java:83-110`` is strictly serial).

    Returns (bytes, consumed) or None when not applicable/anomalous —
    the caller then falls back to the serial path (which also reproduces
    the exact reference error taxonomy for malformed streams).
    """
    if not available():
        return None
    n = len(payload)
    W = workers if workers is not None else (os.cpu_count() or 2)
    if n < min_bytes or W < 2:
        return None
    nbits = n * 8
    bounds = [(k * n // W) * 8 for k in range(1, W)]
    ranges = [
        (bounds[i], bounds[i + 1] if i + 1 < len(bounds) else nbits)
        for i in range(len(bounds))
    ]
    syncs = list(_pool().map(lambda r: _find_sync(payload, r[0], r[1]), ranges))
    starts = [0] + sorted({s for s in syncs if s >= 0})
    stops = starts[1:] + [nbits]
    segs = list(_pool().map(lambda a: _marker_seg(payload, a[0], a[1]), zip(starts, stops)))
    seg_by_start = dict(zip(starts, segs))

    # Adopt the chain (serial, cheap — no byte work): a precomputed segment
    # counts iff the block-boundary walk lands exactly on its start bit.
    chain: list[tuple[np.ndarray, int, int]] = []  # (buf, length, end_bit)
    cur = 0
    done = False
    try:
        for _ in range(2 * len(starts) + 16):
            seg = seg_by_start.pop(cur, None)
            if seg is None or seg[0] != 0:
                # mis-sync repair: decode serially from cur to the next sync
                if seg is not None:
                    _put_buf(seg[1])
                nxt = next((s for s in starts if s > cur), nbits)
                seg = _marker_seg(payload, cur, nxt)
            rc, buf, length, end_bit, hit_final = seg
            if rc != 0 or (not hit_final and end_bit <= cur):
                _put_buf(buf)
                return None  # real stream anomaly: serial path owns the taxonomy
            chain.append((buf, length, end_bit))
            if hit_final:
                done = True
                break
            cur = end_bit
        if not done:
            return None

        # Windows (serial, 32 KiB each): markers reference only the 32 KiB
        # before their segment's start, so window k resolves from the tail
        # of segment k-1 against window k-1 — small slices, not the bodies.
        W32 = 32768
        windows: list[bytes] = [b""]
        for buf, length, _e in chain[:-1]:
            prev = windows[-1]
            if length >= W32:
                w = _resolve_markers(buf[length - W32 : length], prev)
            else:
                whole = _resolve_markers(buf[:length], prev)
                w = (prev + whole)[-W32:] if whole is not None else None
            if w is None:
                return None
            windows.append(w)

        # Parallel resolution straight into the final buffer at precomputed
        # offsets — no serial concat, no per-segment output allocs.
        lengths = [c[1] for c in chain]
        offsets = [0]
        for ln in lengths[:-1]:
            offsets.append(offsets[-1] + ln)
        total = offsets[-1] + lengths[-1] if chain else 0
        final = ctypes.create_string_buffer(max(total, 1))
        base = ctypes.addressof(final)
        lib = _load()

        def _resolve_at(k: int) -> bool:
            buf, length, _e = chain[k]
            win = windows[k]
            rc = lib.td_resolve_markers(
                buf[:length].ctypes.data_as(ctypes.c_void_p),
                length,
                win,
                len(win),
                ctypes.c_void_p(base + offsets[k]),
            )
            return rc == 0
        if not all(_pool().map(_resolve_at, range(len(chain)))):
            return None
        end_bit = chain[-1][2]
        return final.raw[:total], (end_bit + 7) // 8
    finally:
        for seg in seg_by_start.values():
            _put_buf(seg[1])
        for buf, _l, _e in chain:
            _put_buf(buf)


# ---------------------------------------------------------------------------
# Member-parallel drivers (the native engine)
# ---------------------------------------------------------------------------

_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2))
    return _POOL


def compress_members_native(
    data: bytes, *, member_data: int = 64 * 1024, max_code_len: int = 12, max_chain: int = 32
) -> bytes:
    """TD-profile multi-member gzip via the native core, all host cores."""
    from ..codec.profile import _empty_member

    if not data:
        return _empty_member()
    # One foreign call: a C pthread work queue encodes every member (payload,
    # framing, and CRC all in C) and commits them to the output in member
    # order — no per-member Python slices or GIL round-trips.
    lib = _load()
    n = len(data)
    nm = (n + member_data - 1) // member_data
    cap = n + n // 8 + nm * (28 + 1024) + 64
    out = _alloc_bytes(cap)
    got = int(
        lib.td_deflate_members(
            data, n, member_data, max_code_len, max_chain,
            os.cpu_count() or 2, _bytes_ptr(out), cap,
        )
    )
    if got == 0:
        raise RuntimeError("native deflate failed")
    return out[:got]


def compress_continuous_native(
    data: bytes, *, block_data: int = 64 * 1024, max_code_len: int = 15, max_chain: int = 64
) -> bytes:
    """Single-member continuous-history gzip (max ratio, sequential).

    Blocks of ``block_data`` bytes share a sliding 32 KiB history (the
    reference's [history][data] buffering, DeflaterOutputStream.java:38-45),
    emitted bit-contiguously into one member — ~zlib-class ratio, at the
    cost of member-parallel decodability. The TD subfield still indexes
    the single member.
    """
    from ..codec.profile import build_member, _empty_member

    if not data:
        return _empty_member()
    payload = deflate_raw_continuous(
        data, block_data=block_data, max_code_len=max_code_len, max_chain=max_chain
    )
    return build_member(payload, len(data), crc32(data))


def deflate_raw_continuous(
    data: bytes, *, block_data: int = 64 * 1024, max_code_len: int = 15, max_chain: int = 64
) -> bytes:
    """Raw continuous-history DEFLATE stream (no container)."""
    lib = _load()
    if not data:
        # single final stored empty block
        return bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])
    out = bytearray()
    partial = 0
    bitpos = 0
    pos = 0
    n = len(data)
    hist = 32 * 1024
    while pos < n:
        blk = min(block_data, n - pos)
        h = min(hist, pos)
        final = pos + blk >= n
        buf = data[pos - h : pos + blk]
        cap = blk + blk // 4 + 2048
        obuf = ctypes.create_string_buffer(cap)
        bits = lib.td_deflate_block(
            buf, h, blk, obuf, cap, 1 if final else 0, bitpos, partial,
            max_code_len, max_chain,
        )
        if bits == 0:
            raise RuntimeError("native deflate_block failed")
        whole, rem = divmod(int(bits), 8)
        raw = obuf.raw
        out += raw[:whole]
        partial = raw[whole] if rem else 0
        bitpos = rem
        pos += blk
    if bitpos:
        out.append(partial)
    return bytes(out)


def zlib_compress_native(data: bytes, *, max_chain: int = 64) -> bytes:
    """RFC 1950 stream via the native core (DEFAULT level byte)."""
    from ..format.zlib_meta import ZlibMetadata

    return (
        ZlibMetadata().to_bytes()
        + deflate_raw_continuous(data, max_chain=max_chain)
        + adler32(data).to_bytes(4, "big")
    )


def zlib_decompress_native(data: bytes) -> bytes:
    """RFC 1950 decode via the native core (no preset dictionary)."""
    import io as _io

    from ..format.errors import DataFormatError, OutputCapacityError, Reason
    from ..format.zlib_meta import ZlibMetadata

    stream = _io.BytesIO(data)
    meta = ZlibMetadata.read(stream)
    if meta.preset_dictionary is not None:
        from .. import zlib_decompress

        return zlib_decompress(data)  # host path handles FDICT
    off = stream.tell()
    payload = data[off:]
    res = inflate_raw_parallel(payload)
    if res is not None:
        out, consumed = res
    else:
        cap = max(8 * len(payload) + 1024, 1 << 20)
        while True:
            try:
                out, consumed = inflate_raw(payload, cap)
                break
            except OutputCapacityError:
                cap *= 4
    trailer = payload[consumed : consumed + 4]
    if len(trailer) < 4:
        raise DataFormatError(Reason.UNEXPECTED_END_OF_STREAM, "Unexpected end of stream")
    if int.from_bytes(trailer, "big") != adler32(out):
        raise DataFormatError(
            Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression Adler-32 mismatch"
        )
    return out


def gzip_decompress_native(data: bytes) -> bytes:
    """Member-parallel decode via the native core.

    Uses the TD index for O(members) splitting when present; otherwise
    decodes the stream as sequential members (still native-fast).
    """
    from ..format.errors import DataFormatError, OutputCapacityError, Reason
    from ..format.gzip_meta import GzipMetadata
    import io

    lib = _load()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    # Index the stream via the TD subfields (C scan, O(members)).
    cap = len(data) // 4096 + 8
    while True:
        pay_off = np.empty(cap, np.uint64)
        pay_len = np.empty(cap, np.uint64)
        isize = np.empty(cap, np.uint64)
        want_crc = np.empty(cap, np.uint32)
        n = int(
            lib.td_split_members(
                data,
                len(data),
                pay_off.ctypes.data_as(u64p),
                pay_len.ctypes.data_as(u64p),
                isize.ctypes.data_as(u64p),
                want_crc.ctypes.data_as(u32p),
                cap,
            )
        )
        if n != -2:
            break
        cap = len(data) // 31 + 2  # minimum framed member is ~31 bytes
    if n == 0:
        # Empty input: same behavior as the host/tpu engines.
        raise DataFormatError.unexpected_end()
    if n > 0:
        # One foreign call decodes every member: td_inflate_members runs a
        # pthread work queue, each worker inflating straight into the shared
        # output at the member's ISIZE-prefix-sum offset and verifying its
        # CRC-32 in C — no per-member Python slices, buffers, or GIL churn.
        out_off = np.zeros(n + 1, np.uint64)
        np.cumsum(isize[:n], out=out_off[1:])
        total = int(out_off[-1])
        # Allocate the final bytes object up front (uninitialized — the C
        # workers fill every byte) so there is no zero-fill pass and no
        # buffer->bytes copy at the end.
        out = _alloc_bytes(total)
        err_member = ctypes.c_long(-1)
        rc = lib.td_inflate_members(
            data,
            pay_off.ctypes.data_as(u64p),
            pay_len.ctypes.data_as(u64p),
            out_off.ctypes.data_as(u64p),
            want_crc.ctypes.data_as(u32p),
            _bytes_ptr(out),
            n,
            os.cpu_count() or 2,
            ctypes.byref(err_member),
        )
        if rc != 0:
            from ..format.errors import code_to_reason

            reason = code_to_reason(rc)
            raise DataFormatError(reason, f"{reason.name} (member {err_member.value})")
        return out

    # Foreign stream: sequential member walk, native inflate per member.
    out_parts = []
    stream = io.BytesIO(data)
    while True:
        pos = stream.tell()
        probe = stream.read(1)
        if not probe:
            break
        stream.seek(pos)
        GzipMetadata.read(stream)
        payload_start = stream.tell()
        payload = data[payload_start:]
        res = inflate_raw_parallel(payload)
        if res is not None:
            out, consumed = res
        else:
            cap = max(8 * len(payload) + 1024, 1 << 20)
            while True:
                try:
                    out, consumed = inflate_raw(payload, cap)
                    break
                except OutputCapacityError:  # grow and retry; format errors propagate
                    cap *= 4
        trailer = payload[consumed : consumed + 8]
        if len(trailer) < 8:
            raise DataFormatError(Reason.UNEXPECTED_END_OF_STREAM, "Unexpected end of stream")
        want_crc = int.from_bytes(trailer[:4], "little")
        want_len = int.from_bytes(trailer[4:8], "little")
        if crc32(out) != want_crc:
            raise DataFormatError(
                Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
            )
        if (len(out) & 0xFFFFFFFF) != want_len:
            raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "Decompressed size mismatch")
        out_parts.append(out)
        stream.seek(payload_start + consumed + 8)
    return b"".join(out_parts)
