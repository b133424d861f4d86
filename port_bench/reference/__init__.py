"""The plain reference: NumPy and plain PyTorch, importing nothing of the
program."""
