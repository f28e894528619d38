"""The paper's own Lorenz96 twin configuration (Methods), plus the
fleet-serving scale-up scenario built on it (Fig. 4): many assets sharing
one trained twin, served by :mod:`repro_torch.launch.fleet_serving`.

The port's own copy of ``repro/configs/lorenz96_twin.py``; the fleet
serves on the hand-written CUDA kernel (``backend="fused_cuda"``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class Lorenz96TwinConfig:
    state_dim: int = 6
    forcing: float = 8.0
    hidden: int = 64              # three-layer net, 64 per hidden layer
    n_hidden_layers: int = 2
    num_points: int = 2400
    train_points: int = 1800      # interpolation window
    dt: float = 0.0025            # total span ~13 Lyapunov times
    method: str = "rk4"
    gradient: str = "adjoint"
    loss: str = "l1+softdtw"
    noise_regulariser: float = 0.02


CONFIG = Lorenz96TwinConfig()


@dataclasses.dataclass(frozen=True)
class Lorenz96FleetConfig:
    """Fleet serving: N independent Lorenz96 assets, one trained twin.

    The model sizes mirror :class:`Lorenz96TwinConfig` (weights drop
    straight in via ``train.checkpoint.save_twin`` / ``load_twin``); the
    serving knobs size the request stream and the fleet padding tile.
    """
    state_dim: int = 6
    hidden: int = 64
    n_hidden_layers: int = 2
    dt: float = 0.0025            # same grid the twin was trained on
    fleet_size: int = 1024        # assets per request batch
    horizon: int = 200            # RK4 steps per request
    y0_spread: float = 0.5        # stddev of sensed initial conditions
                                  # (the training data is normalised)
    backend: str = "fused_cuda"
    batch_tile: int = 64          # fleet padding unit of the fused kernel


FLEET = Lorenz96FleetConfig()
