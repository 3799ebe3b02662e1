"""Element-sharded solves over `torch.distributed` ranks.

- `context` — `SolverShardCtx` and `make_solver_ctx`: one rank per shard,
  each on its own device, and the shard-grid spec of the partition.
- `launch`  — `spawn`: start N local ranks with a file store, run one
  function on every rank and collect what each returns.
"""
