"""The benchmark's plain reference: float32 PyTorch from the published
architectures. Nothing here imports the program."""
