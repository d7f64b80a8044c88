"""Multi-device scaling: meshes, data-parallel training, edge-partitioned
aggregation, and sharded walk generation.

The reference's only distributed component is the Spark node2vec
(`node2vec_spark/`, RDD shuffle-join per walk step, `Node2vec.scala:103-124`);
its training stacks are single-process CPU. This package is the device
scale-out design per SURVEY.md §2.7/§7-8: `jax.sharding` meshes with GSPMD /
`shard_map` collectives over the device interconnect replace RDD shuffles.
"""

from linkpred.parallel.mesh import make_mesh  # noqa: F401
