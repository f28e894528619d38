"""The paper's own HP-memristor twin configuration (Methods).

The port's own copy of ``repro/configs/hp_twin.py``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class HPTwinConfig:
    state_dim: int = 1
    drive_dim: int = 1
    hidden: int = 14              # the 2x14 / 14x14 / 14x1 crossbars
    n_hidden_layers: int = 2
    num_points: int = 500
    dt: float = 1e-3
    method: str = "rk4"
    gradient: str = "adjoint"
    train_waveform: str = "sine"
    eval_waveforms: tuple = ("sine", "triangular", "rectangular",
                             "modulated_sine")
    loss: str = "l1"


CONFIG = HPTwinConfig()
