"""Element-sharded solves over `torch.distributed` ranks.

- `context`     — `SolverShardCtx` and `make_solver_ctx`: one rank per
  shard, each on its own device, the shard-grid spec of the partition,
  the interface exchange (psum or neighbour) and its halo codec.
- `launch`      — `spawn`: start N local ranks with a file store, run one
  function on every rank and collect what each returns.
- `compression` — the neighbour exchange's halo codecs (bf16, int8).
"""
