"""Engine selection: one front door over the three codec backends.

- ``native``: C host runtime, member-parallel over host cores (fastest on
  this machine; the production host path).
- ``tpu``: the JAX device kernels (bit-parallel decode, batched analyze
  encode) on the accelerator (the name is historical; ROADMAP D8).
- ``host``: pure Python/NumPy reference implementations (always present).

``auto`` picks native when the compiler toolchain produced the extension,
else host. All engines emit/consume the same standard formats; outputs
are interchangeable and cross-verified in tests.
"""

from __future__ import annotations

import io


def _encoder_cfg(config):
    from .config import EncoderConfig, FrameworkConfig

    if config is None:
        return EncoderConfig()
    if isinstance(config, FrameworkConfig):
        return config.encoder
    return config


def _decoder_cfg(config):
    from .config import DecoderConfig, FrameworkConfig

    if config is None:
        return DecoderConfig()
    if isinstance(config, FrameworkConfig):
        return config.decoder
    return config


def compress(
    data: bytes,
    *,
    engine: str | None = None,
    effort: int | None = None,
    metadata=None,
    config=None,
    mesh=None,
) -> bytes:
    """Compress to (profile) gzip with the selected engine.

    ``config`` (an :class:`~tpu_deflate.config.EncoderConfig` or
    :class:`~tpu_deflate.config.FrameworkConfig`) supplies the defaults
    for every knob; explicit keyword arguments win over it. ``mesh``
    (or a non-trivial ``FrameworkConfig.mesh``) shards the max-ratio
    continuous-history mode (effort >= 4) over the mesh: ppermute halo
    exchange of the 32 KiB windows, shard-parallel block encode, host
    bit-splice into one member (dist.sharded.sharded_continuous_compress).
    """
    from .config import FrameworkConfig

    cfg = _encoder_cfg(config)
    if mesh is None and isinstance(config, FrameworkConfig):
        from .dist.mesh import mesh_from_config

        mesh = mesh_from_config(config.mesh)
    engine = _resolve(engine if engine is not None else cfg.engine)
    effort = effort if effort is not None else cfg.effort
    if engine == "native":
        from . import native

        if effort == 0:
            # stored-only goes through the host strategy system
            import tpu_deflate as td

            return td.gzip_compress(data, effort=0, metadata=metadata)
        if effort >= 4:
            # max-ratio mode: one member, continuous 32 KiB history across
            # blocks (beats zlib-9 and the reference's strongest preset
            # composition on the measured corpora); trades away
            # member-parallel decode.
            chain = 512 if effort == 4 else 4096
            if mesh is not None:
                from .dist.sharded import sharded_continuous_compress

                out = sharded_continuous_compress(
                    data, mesh, block_data=cfg.lookahead, max_chain=chain
                )
                return _prepend_metadata(out, metadata)
            out = native.compress_continuous_native(
                data, block_data=cfg.lookahead, max_chain=chain
            )
        else:
            chain = {1: 4, 2: 48, 3: 192}[effort]
            out = native.compress_members_native(
                data,
                member_data=cfg.member_data,
                max_code_len=cfg.max_code_len,
                max_chain=chain,
            )
        return _prepend_metadata(out, metadata)
    if engine == "tpu":
        if effort >= 4:
            # Max-ratio mode on device: one member, the 32 KiB halo of
            # each 64 KiB block rides into the analyze kernel as a
            # history prefix (continuous history across blocks — the
            # tier that beats zlib-9 on the host ladder, now device-
            # native; host bit-splice + mesh sharding in encode_jax).
            from .codec.encode_jax import compress_continuous_tpu

            return _prepend_metadata(
                compress_continuous_tpu(
                    data, effort=effort, block_data=cfg.lookahead, mesh=mesh
                ),
                metadata,
            )
        from .codec.encode_jax import compress_members_tpu

        return _prepend_metadata(compress_members_tpu(data, effort=effort), metadata)
    import tpu_deflate as td

    return td.gzip_compress(data, effort=effort, metadata=metadata)


def decompress(data: bytes, *, engine: str | None = None, config=None, mesh=None) -> bytes:
    """Decompress gzip with the selected engine.

    ``mesh`` (a jax.sharding.Mesh; implies engine="tpu") shards the device
    decode's lane axis data-parallel over the mesh — multi-device decode
    with bit-exact single-device semantics.
    """
    from .config import FrameworkConfig

    cfg = _decoder_cfg(config)
    if mesh is None and isinstance(config, FrameworkConfig):
        # A non-trivial MeshConfig selects the sharded device decode.
        from .dist.mesh import mesh_from_config

        mesh = mesh_from_config(config.mesh)
    if mesh is not None:
        engine = "tpu"
    else:
        engine = _resolve(engine if engine is not None else cfg.engine)
    if engine == "native":
        from . import native

        return native.gzip_decompress_native(data)
    if engine == "tpu":
        from .codec.decode_jax_v2 import gzip_decompress_tpu_v2

        return gzip_decompress_tpu_v2(
            data,
            verify_crc=cfg.verify_crc,
            mesh=mesh,
            lane_batch=cfg.lane_batch,
            device_resolve=getattr(cfg, "device_resolve", "auto"),
        )
    import tpu_deflate as td

    return td.gzip_decompress(data)


def _resolve(engine: str) -> str:
    if engine != "auto":
        return engine
    try:
        from . import native

        if native.available():
            return "native"
    except Exception:
        pass
    return "host"


def _prepend_metadata(out: bytes, metadata) -> bytes:
    """Metadata rides on a leading empty member that still carries the TD
    size subfield, so the stream stays O(members)-splittable."""
    if metadata is None:
        return out
    from dataclasses import replace

    from .codec.profile import TD_SUBFIELD
    from .kernels.checksum import crc32

    # Merge a TD subfield (placeholder size) into the metadata's FEXTRA.
    td_field = TD_SUBFIELD + (4).to_bytes(2, "little") + bytes(4)
    extra = (metadata.extra_field or b"") + td_field
    meta2 = replace(metadata, extra_field=extra)
    header = bytearray(meta2.to_bytes())
    empty_payload = bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])  # final stored, len 0
    trailer = crc32(b"").to_bytes(4, "little") + bytes(4)
    total = len(header) + len(empty_payload) + len(trailer)
    # Patch the TD size (the last subfield of the extra block).
    xlen_off = 12 + len(extra) - 4
    header[xlen_off : xlen_off + 4] = total.to_bytes(4, "little")
    if meta2.has_header_crc:
        # header CRC covers everything before it; recompute last two bytes
        header[-2:] = (crc32(bytes(header[:-2])) & 0xFFFF).to_bytes(2, "little")
    return bytes(header) + empty_payload + trailer + out
