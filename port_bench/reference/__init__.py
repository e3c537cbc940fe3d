"""The plain reference: PyTorch and Python only, nothing of the program."""
