"""LM models of the port (the reference's `models/`): configs, parameter
specs, layers, attention, the dense/MoE/VLM decoder, the hybrid, xLSTM and
enc-dec/audio models, and their registry."""
