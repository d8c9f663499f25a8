"""The plain reference the benchmark checks the program against; it imports nothing of
the program."""
