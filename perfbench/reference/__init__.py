"""The plain references that decide `correct`: float32 PyTorch written
from the published architectures, importing nothing of the program."""
