"""The plain reference the benchmark holds the port to: torch and numpy
only, nothing of the program."""
