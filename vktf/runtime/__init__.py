"""Runtime services: compiled-program registry + persistent compile cache."""

from vktf.runtime.cache import (  # noqa: F401
    enable_persistent_cache,
    frame_program,
    program_cache_info,
    warmup,
)
