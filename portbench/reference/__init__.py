"""Plain PyTorch references the benchmark's output check compares with.
They import nothing of the program."""
