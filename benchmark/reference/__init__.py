"""The plain reference of the benchmark: float32 PyTorch written out from
the algorithms, importing nothing of the program under test."""
