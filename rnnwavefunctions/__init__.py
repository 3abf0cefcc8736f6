"""RNN wavefunctions trained by Variational Monte Carlo.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
MatteoMartinelli97/RNNWavefunctions (Hibat-Allah et al., Phys. Rev. Research
2, 023358 (2020)).  See SURVEY.md for the reference blueprint.
"""

__version__ = "0.1.0"

from .models.prnn1d import PRNN1D
from .models.prnn_snake2d import PRNNSnake2D
from .models.mdrnn2d import MDRNN2D
from .models.crnn_u1 import CRNNU1
from .hamiltonians.tfim1d import TFIM1D
from .hamiltonians.tfim2d import TFIM2D
from .hamiltonians.j1j2 import J1J2
from .vmc.trainer import TrainConfig, TrainState, VMCTrainer
from .parallel.mesh import make_mesh

__all__ = [
    "PRNN1D",
    "PRNNSnake2D",
    "MDRNN2D",
    "CRNNU1",
    "TFIM1D",
    "TFIM2D",
    "J1J2",
    "TrainConfig",
    "TrainState",
    "VMCTrainer",
    "make_mesh",
]
