"""Alignment engines: the exact host oracle and the PyTorch/CUDA engine."""
