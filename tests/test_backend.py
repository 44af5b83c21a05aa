"""The per-platform stage table, the compile-cache placement, and the
decode-path record (LAST_DECODE_STATS)."""

from __future__ import annotations

import gzip as pygzip

import numpy as np
import pytest

from tpu_deflate.kernels import backend, jax_setup


@pytest.mark.parametrize("platform,device_resolve", [("gpu", True), ("cpu", False)])
def test_backend_table_choice(platform, device_resolve):
    assert backend.backend_for(platform).device_resolve is device_resolve


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL", ""])
def test_backend_table_rejects_unknown_platform(platform):
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        backend.backend_for(platform)


def test_backend_current_is_the_cpu_entry_here():
    assert backend.current() == backend.backend_for("cpu")


@pytest.mark.parametrize("env_value", [None, "", "/some/where/else"])
def test_compile_cache_placement(env_value):
    """Set: JAX reads the variable itself and the module configures
    nothing. Unset (or empty): a fixed directory inside the checkout."""
    env = {} if env_value is None else {jax_setup.ENV_VAR: env_value}
    got = jax_setup.cache_dir(env)
    if env_value:
        assert got is None
    else:
        assert got == jax_setup.REPO_CACHE_DIR
        assert got.name == ".jax_cache"
        assert got.parent == jax_setup.Path(__file__).resolve().parents[1]


def test_compile_cache_gitignored():
    from pathlib import Path

    ignore = (Path(__file__).resolve().parents[1] / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignore


def _td_stream():
    from tpu_deflate.codec.profile import profile_compress_host

    rng = np.random.default_rng(3)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(50)]
    data = np.concatenate([words[i] for i in rng.integers(0, 50, 30000)]).tobytes()[:100000]
    return data, profile_compress_host(data)


def _residue_everywhere(monkeypatch):
    """Make the device resolve report an unresolved residue on every lane."""
    from tpu_deflate.codec import resolve_jax as rp

    orig = rp.resolve_tokens_device

    def fake(tokens, *, tail=None):
        y, summ, rounds, unres = orig(tokens, tail=tail)
        return y, summ.at[:, 3].set(1), rounds, unres

    monkeypatch.setattr(rp, "resolve_tokens_device", fake)


@pytest.mark.parametrize("case", ["auto_cpu", "forced_on", "residue", "foreign"])
def test_last_decode_stats_path_fields(case, monkeypatch):
    from tpu_deflate.codec.decode_jax_v2 import LAST_DECODE_STATS, gzip_decompress_tpu_v2

    monkeypatch.delenv("TD_DEVICE_RESOLVE", raising=False)
    data, gz = _td_stream()
    mode = "auto"
    if case == "foreign":
        gz = pygzip.compress(data)
    if case in ("forced_on", "residue"):
        mode = "on"
    if case == "residue":
        _residue_everywhere(monkeypatch)
    assert gzip_decompress_tpu_v2(gz, device_resolve=mode) == data
    s = dict(LAST_DECODE_STATS)
    assert set(s) == {
        "members", "stored", "device_resolved", "host_resolved",
        "residue_fallback", "overflow_fallback", "gzip_reader",
    }
    if case == "foreign":
        assert s["gzip_reader"] == 1 and s["members"] == 0
        return
    huff = s["members"] - s["stored"]
    assert s["gzip_reader"] == 0 and huff == 2
    assert s["device_resolved"] + s["host_resolved"] == huff
    assert s["overflow_fallback"] == 0
    if case == "auto_cpu":
        assert (s["device_resolved"], s["residue_fallback"]) == (0, 0)
    elif case == "forced_on":
        assert (s["device_resolved"], s["residue_fallback"]) == (huff, 0)
    else:
        # every lane falls back from the single-block path; the forced
        # big-stream device resolve then reports residue again too
        assert s["device_resolved"] == 0 and s["residue_fallback"] == 2 * huff
