"""The harness of the port's benchmark: finds a cell by name, makes its
inputs from the seed, drives the program, reduces the trace, checks the
answers against the plain reference and prints the result line."""
