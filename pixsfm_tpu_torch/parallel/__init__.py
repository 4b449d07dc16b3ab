from .sharded import (  # noqa: F401
    Mesh, make_mesh, parallel_mesh, shard_ka_chunk, sharded_ba_solve,
    sharded_ka_solve, sharded_reference_extraction,
)
