"""The port's models (port of ``repro/models``): the LM model zoo (shared
layers, GQA attention, Mamba, MoE and the model assembly that drives
them) and the twin's digital baselines (``baselines``)."""
