"""LM models of the port (the reference's `models/`): configs, parameter
specs, layers, attention, the dense decoder and its registry."""
