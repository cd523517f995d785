"""The model zoo's dense and ssm families, ported to PyTorch."""
