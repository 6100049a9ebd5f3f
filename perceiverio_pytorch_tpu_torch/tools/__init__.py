"""Developer tools of the PyTorch/CUDA port."""
