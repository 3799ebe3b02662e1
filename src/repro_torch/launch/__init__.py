"""Launchers of the port (the reference's `launch/`): LM serving."""
