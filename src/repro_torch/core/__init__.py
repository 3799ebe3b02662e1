"""Core library of the port: spectral basis, mesh generation, element
geometry, sum-factorization contractions, the axhelm operator,
gather-scatter, PCG and the Nekbone problem (single device)."""
