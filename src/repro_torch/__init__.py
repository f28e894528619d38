"""PyTorch/CUDA port of :mod:`repro`, the memristive neural-ODE digital twin.

The package mirrors the JAX package's module paths (``core/ode.py``,
``kernels/fused_ode_mlp.py``, ``launch/fleet_serving.py``, ...) so each
ported part sits where its counterpart does.  It imports ``torch``,
numpy and the standard library only.  The TPU kernels of the JAX package
become hand-written Hopper kernels under ``kernels/csrc/``, built with
``nvcc`` at first use (:mod:`repro_torch.kernels._build`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there is no silent fall back to the CPU (:func:`repro_torch.device.resolve_device`).
"""
