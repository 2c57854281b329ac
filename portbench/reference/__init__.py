"""The plain reference of the benchmark: plain PyTorch that reads the
configuration's table files itself and imports nothing of the program."""
