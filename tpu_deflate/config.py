"""Configuration dataclasses (SURVEY.md §5.6 build component).

The reference exposes its knobs as constructor parameters and constants
(strategy presets ``comp/Lz77Huffman.java:298-305``, deflater capacities
``DeflaterOutputStream.java:55-65``, inflater buffer
``InflaterInputStream.java:96-106``, ``CODE_TABLE_BITS``,
``MAX_BLOCK_LEN``, ``DICTIONARY_LENGTH``). This module mirrors them 1:1
as one typed config plus the TPU-side knobs (member size, lane batches,
mesh shape, profile code-length cap).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class EncoderConfig:
    """Knobs of the encode path (host strategies + device profile)."""

    # ≙ DeflaterOutputStream defaults (DeflaterOutputStream.java:50-52)
    lookahead: int = 64 * 1024
    history: int = 32 * 1024
    effort: int = 2  # maps via tpu_deflate.strategy_for_effort
    # device / native profile
    member_data: int = 64 * 1024
    max_code_len: int = 12  # device decode LUT profile cap
    max_chain: int = 32  # native matcher chain depth
    lazy: bool = True
    engine: str = "auto"


@dataclass(frozen=True)
class DecoderConfig:
    """Knobs of the decode path."""

    # ≙ InflaterInputStream input buffer (InflaterInputStream.java:72)
    buffer_size: int = 16 * 1024
    verify_crc: bool = True
    engine: str = "auto"
    # device decode: members per batched device dispatch (consumed by
    # engine.decompress -> gzip_decompress_tpu_v2; capped at V2_LANE_BATCH)
    lane_batch: int = 256
    # on-device LZ77 resolve + CRC for single-block members ("auto" =
    # where kernels.backend says so, the GPU; "on"/"off" force;
    # TD_DEVICE_RESOLVE env overrides)
    device_resolve: str = "auto"
    # failure isolation (SURVEY.md §5.3): "raise" fails the job on the
    # first bad member; "skip" drops bad members and records them.
    on_error: str = "raise"


@dataclass(frozen=True)
class MeshConfig:
    """Device topology: hosts x devices per host (SURVEY.md §2.2)."""

    data_axis: str = "data"
    host_axis: str = "host"
    hosts: int = 1
    chips_per_host: int = 1


@dataclass(frozen=True)
class FrameworkConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


DEFAULT = FrameworkConfig()
