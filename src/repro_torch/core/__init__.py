"""AGORA core: the paper's planner, ported to PyTorch."""
