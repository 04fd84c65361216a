"""The plain float32 reference the check holds the program to."""
