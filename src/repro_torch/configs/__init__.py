"""Configurations the port runs (the Nekbone workload so far)."""
