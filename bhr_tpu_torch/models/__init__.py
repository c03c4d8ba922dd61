"""Scene models (skybox, lifecycle disk) of the PyTorch/CUDA port."""
