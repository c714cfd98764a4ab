"""The dense GQA transformer family of the model zoo, in PyTorch."""
