"""The plain reference: plain PyTorch that imports nothing of the program."""
