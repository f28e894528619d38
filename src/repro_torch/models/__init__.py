"""The LM model zoo of the port (port of ``repro/models``): shared layers,
GQA attention, Mamba, MoE and the model assembly that drives them."""
