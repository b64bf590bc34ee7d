"""Process-level JAX configuration shared by every entry point: the
persistent compilation cache. CLI runs are short-lived processes, so
without it every run compiles its device steps again."""

import os

# a fixed path inside the checkout: the cache key includes the directory,
# so a location that moves between runs never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

_done = False


def ensure_jax_cache():
    """Enable the persistent compilation cache (idempotent, safe before the
    backend starts). JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only
    when it is unset does this point the cache at ``DEFAULT_CACHE_DIR``.
    Returns the directory in use."""
    global _done
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if not _done:
        import jax

        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        _done = True
    return DEFAULT_CACHE_DIR
