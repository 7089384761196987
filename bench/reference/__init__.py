"""The plain reference: the model's forward in float32 PyTorch, written
from the configuration file alone. It imports nothing of the program."""
