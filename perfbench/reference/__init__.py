"""The plain reference the benchmark judges the port by: float32 PyTorch
and NumPy, importing nothing of the port."""
