"""Performance contracts of the port, checked on what its entry points run.

The counterpart of `repro.analysis`, which checks the programs XLA
compiles.  PyTorch compiles no such program, so the port records what runs:

  * ``record``     — the aten ops (a `TorchDispatchMode`) and the
                     collectives (`all_reduce`, `batch_isend_irecv`) of one
                     captured loop body or one operator application;
  * ``contracts``  — declarative contract objects (`CollectiveCensus`,
                     `WireWidth`, `AccumulationDtype`, `NoF64Leak`,
                     `NoHostTransfer`, `ResourceBudget`, `NoRetrace`)
                     evaluated against an entry point's records;
  * ``lint``       — the registry of the port's real entry points bound to
                     contract suites; ``python -m repro_torch.analysis.lint``
                     is the check.
"""
