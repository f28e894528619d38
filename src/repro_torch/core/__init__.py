"""The twin's numerics: integrators, vector fields, backends, losses."""
from repro_torch.core.ode import make_odeint, odeint, odeint_dopri5, rk4_step

__all__ = ["make_odeint", "odeint", "odeint_dopri5", "rk4_step"]
