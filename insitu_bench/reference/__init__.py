"""The plain reference: the same answers worked out again in plain PyTorch
from the same inputs, importing nothing of the program under test."""
