"""The paper's own workload: Nekbone PCG on trilinear hexahedral meshes.

Default: N=7 (the paper's choice: NekRS default + Tensor-Core-friendly),
E selectable; Poisson/Helmholtz, d in {1, 3}.  Every axhelm variant of the
port runs it: precomputed, trilinear, parallelepiped (on an affinely
deformed box), merged (Helmholtz) and partial (Poisson).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class NekboneConfig:
    name: str = "nekbone"
    order: int = 7
    elements: tuple = (16, 16, 16)     # nx, ny, nz => E = 4096
    helmholtz: bool = False
    d: int = 1
    variant: str = "trilinear"         # paper Algorithm 3
    precision: str = "float32"
    preconditioner: str = "jacobi"
    max_iter: int = 200
    tol: float = 1e-8


CONFIG = NekboneConfig()
