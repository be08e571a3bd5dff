"""Plain reference of what the benchmark measures; imports nothing of the program."""
