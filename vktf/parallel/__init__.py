"""Multi-chip parallel rendering over a jax.sharding.Mesh."""

from vktf.parallel.tiles import (  # noqa: F401
    make_render_mesh,
    make_sharded_frame_fn,
    render_frame_sharded,
)
