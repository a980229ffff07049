"""Numerics shared by the models and the likelihood; ``ops.cuda`` holds the
hand-written kernels and their plain PyTorch versions."""
