"""The plain reference, in NumPy; it imports nothing of the program."""
