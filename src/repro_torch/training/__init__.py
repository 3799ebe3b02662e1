"""Training substrate: optimizer, train loop, checkpointing, fault tolerance
(the reference's `training/`)."""
