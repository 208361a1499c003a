"""The key that says which sources, command and host built a library.

A library compiled here carries host-specific code (g++ -march=native for
the entropy front-end).  Each build writes a stamp file next to the
library holding a hash of its sources, its compile command and the host
CPU; a library whose stamp differs — a build directory copied from
another machine, or edited sources — is rebuilt, never loaded.
"""

from __future__ import annotations

import hashlib
import os
import platform


def host_signature() -> str:
    """The CPU model and feature flags (what -march=native compiles for)
    and the machine architecture."""
    model = flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key == "model name" and not model:
                    model = line.split(":", 1)[1].strip()
                elif key in ("flags", "Features") and not flags:
                    flags = line.split(":", 1)[1].strip()
                if model and flags:
                    break
    except OSError:
        pass
    return f"{platform.machine()}|{model}|{flags}"


def build_key(*parts: bytes) -> str:
    """16 hex digits over the given byte strings and the host signature."""
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    h.update(host_signature().encode())
    return h.hexdigest()[:16]


def _stamp(lib_path: str) -> str:
    return lib_path + ".key"


def is_current(lib_path: str, key: str) -> bool:
    """True if `lib_path` exists and was built under `key`."""
    try:
        with open(_stamp(lib_path)) as f:
            return f.read().strip() == key and os.path.exists(lib_path)
    except OSError:
        return False


def mark_current(lib_path: str, key: str) -> None:
    with open(_stamp(lib_path), "w") as f:
        f.write(key + "\n")
