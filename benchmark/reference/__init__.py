"""The plain reference of the served model (imports nothing of the program)."""
