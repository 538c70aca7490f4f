"""Where JAX keeps its persistent compilation cache for this repository.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and that
directory is the only cache: nothing here sets another one. Otherwise the
cache lives at one fixed path inside the checkout, `<repo>/.jax_cache`
(listed in .gitignore) - the directory is part of the cache key, so it
must not move between runs.

XLA:CPU persists AOT-compiled host code into the cache. If the machine
changes to a host with a different ISA, loading such an entry emits only
a warning ("could lead to execution errors such as SIGILL") and then
crashes. `ensure_cache_dir` stamps the directory this module owns with the
host's CPU feature signature and wipes it in place when the signature
changes; a directory named by JAX_COMPILATION_CACHE_DIR is never touched.
"""

from __future__ import annotations

import hashlib
import os
import shutil

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
_MARKER = ".host_cpu_signature"


def _host_signature() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(
                        " ".join(sorted(line.split()[2:])).encode()
                    ).hexdigest()
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.processor().encode()).hexdigest()


def _stamp(path: str, sig: str) -> str:
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, _MARKER)
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write(sig)
    return path


def ensure_cache_dir(path: str = DEFAULT_DIR) -> str:
    """Return a jax compilation-cache dir valid for THIS host's ISA.

    Never adopts cache entries this module did not stamp: a marker written
    by us proves the entries' ISA, so a stale marker means OUR cache from
    another host and is wiped in place. A non-empty directory WITHOUT a
    marker may belong to anything (a shared jax cache, a mistyped path) —
    deleting it would be destructive, and stamping it would make possibly
    stale-ISA entries permanent — so the cache is redirected to a
    signature-keyed subdirectory instead and the foreign contents are left
    untouched.
    """
    sig = _host_signature()
    marker = os.path.join(path, _MARKER)
    try:
        with open(marker) as f:
            if f.read().strip() == sig:
                return path
        # Our own marker with a different signature: this is our cache
        # from a different host ISA — wipe in place and re-stamp.
        shutil.rmtree(path, ignore_errors=True)
        return _stamp(path, sig)
    except OSError:
        pass
    try:
        nonempty = os.path.isdir(path) and any(os.scandir(path))
    except OSError:
        nonempty = False
    if nonempty:
        # Unmarked, non-empty: not provably ours. Use an ISA-keyed
        # subdirectory (itself marker-stamped) and leave the rest alone.
        return _stamp(os.path.join(path, f"by-isa-{sig[:12]}"), sig)
    return _stamp(path, sig)


def cache_dir() -> str:
    """The compilation-cache directory in use: JAX_COMPILATION_CACHE_DIR if
    set, else the ISA-stamped fixed directory in the checkout."""
    return os.environ.get(ENV_VAR) or ensure_cache_dir(DEFAULT_DIR)


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Sets the directory only when JAX_COMPILATION_CACHE_DIR is unset (JAX
    already reads the variable itself)."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path
