"""Native libraries are keyed on their sources and the host that built
them, so a build directory copied from another machine is rebuilt."""

import os

import pytest

from h263_tpu.native import bindings, buildkey


def test_key_changes_with_sources_and_host(monkeypatch):
    a = buildkey.build_key(b"src", b"flags")
    assert a == buildkey.build_key(b"src", b"flags")
    assert a != buildkey.build_key(b"src2", b"flags")
    assert a != buildkey.build_key(b"srcf", b"lags")  # parts are framed
    monkeypatch.setattr(buildkey, "host_signature", lambda: "other-host")
    assert a != buildkey.build_key(b"src", b"flags")


def test_host_signature_names_the_machine():
    import platform

    assert buildkey.host_signature().startswith(platform.machine() + "|")


def test_stamp_roundtrip(tmp_path):
    lib = str(tmp_path / "libx.so")
    assert not buildkey.is_current(lib, "k1")
    (tmp_path / "libx.so").write_bytes(b"\x7fELF")
    assert not buildkey.is_current(lib, "k1")     # no stamp yet
    buildkey.mark_current(lib, "k1")
    assert buildkey.is_current(lib, "k1")
    assert not buildkey.is_current(lib, "k2")


@pytest.fixture
def private_build(monkeypatch, tmp_path):
    """bindings' library path redirected into tmp_path."""
    lib = tmp_path / "libh263entropy.so"
    monkeypatch.setattr(bindings, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(bindings, "_LIB_PATH", str(lib))
    return lib


def test_foreign_build_is_rebuilt(private_build):
    """A library stamped by another host (or not stamped) is recompiled."""
    private_build.write_bytes(b"not a library from this host")
    buildkey.mark_current(str(private_build), "another-host-key")
    assert bindings._build()
    assert private_build.read_bytes()[:4] == b"\x7fELF"
    stamp = private_build.read_bytes()
    assert bindings._build()                          # current: reused
    assert private_build.read_bytes() == stamp


def test_forced_rebuild_recompiles(private_build):
    assert bindings._build()
    before = os.stat(private_build).st_mtime_ns
    assert bindings._build(force=True)
    assert os.stat(private_build).st_mtime_ns != before


def test_forced_rebuild_after_load_is_refused(monkeypatch):
    """A rebuild cannot replace a library the process already loaded."""
    assert bindings.ensure_built()
    with pytest.raises(RuntimeError, match="already loaded"):
        bindings.ensure_built(force_rebuild=True)
