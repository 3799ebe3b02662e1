"""Data pipeline: deterministic resumable synthetic streams + prefetch (the
reference's `data/`)."""
