"""Sharded dense indexes (port of cosdata_tpu/parallel/).

``sharded_hnsw.ShardedHNSWIndex`` is the engine a collection with
``shards > 1`` serves from: one HNSW sub-index per shard, each on its own
device, searched in fan-out and merged on the host. ``sharded`` is the
mesh formulation of a flat index: rows split over "dp", dimensions over
"tp", partial products summed over "tp" and per-row top-k lists merged
over "dp", by one process that owns every device of the mesh.
"""
