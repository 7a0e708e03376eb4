"""PyTorch/CUDA port of the dense retriever (see README, "PyTorch / H100 port")."""
