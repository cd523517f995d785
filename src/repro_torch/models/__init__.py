"""The model zoo's dense, moe, ssm, vlm and audio families, in PyTorch."""
