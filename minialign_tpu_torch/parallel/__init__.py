"""The parallel paths, the port's counterpart of minialign_tpu/parallel/:
`-tN` worker processes with the rank-ordered merge (hostworker,
distributed), multi-host runs (distributed, dist_host), and the engine
and index sharded over several devices (shard, with the sharded lookup
as a CUDA kernel in cuda_lookup)."""
