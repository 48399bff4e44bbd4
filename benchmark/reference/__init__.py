"""The plain reference: exact k-nearest neighbours by brute force in plain
PyTorch (TF32 off). It imports nothing of the port and takes nothing the
port made: the harness hands it the same rows and queries it hands the
program."""
