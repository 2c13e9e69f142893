"""Device mesh construction for the match->filter->align workflow.

The reference's only parallelism is batch-level job scheduling over a shared
filesystem (SURVEY.md section 2c); it has no distributed backend. This
build introduces one, with two mesh axes:

  "d" (doc shards)   genome-document columns of the Bloom bit-matrix are
                     sharded across devices — the model/tensor-parallel
                     axis.
                     The filter stage's top-k runs as a collective over "d".
  "q" (query shards) query streams are data-parallel across devices.

The cards of one host are joined all to all (NVLink), so the mesh layout
follows the algorithm alone; XLA hands the collectives to NCCL. Across hosts
the same program runs under jax.distributed with the mesh spanning all
processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_DOC = "d"
AXIS_QUERY = "q"


def make_mesh(
    n_doc_shards: int | None = None, n_query_shards: int | None = None
) -> Mesh:
    """Mesh over all visible devices. Defaults: all devices on the doc axis
    (the bit-matrix is the big thing; sharding it is what buys memory)."""
    devs = np.array(jax.devices())
    n = devs.size
    if n_doc_shards is None and n_query_shards is None:
        n_doc_shards, n_query_shards = n, 1
    elif n_doc_shards is None:
        n_doc_shards = n // n_query_shards
    elif n_query_shards is None:
        n_query_shards = n // n_doc_shards
    assert n_doc_shards * n_query_shards == n, (
        f"mesh {n_doc_shards}x{n_query_shards} != {n} devices"
    )
    return Mesh(
        devs.reshape(n_doc_shards, n_query_shards), (AXIS_DOC, AXIS_QUERY)
    )


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """'4x2' -> (4, 2) doc x query shards (config.mesh_shape)."""
    d, _, q = spec.partition("x")
    return int(d), int(q)


def words_sharding(mesh: Mesh) -> NamedSharding:
    """Bit-matrix [S+1, Wp]: word columns sharded over the doc axis."""
    return NamedSharding(mesh, P(None, AXIS_DOC))


def queries_sharding(mesh: Mesh) -> NamedSharding:
    """Per-query arrays [Q, ...]: sharded over the query axis."""
    return NamedSharding(mesh, P(AXIS_QUERY))
