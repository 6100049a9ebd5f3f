"""Runnable examples of the PyTorch/CUDA port."""
