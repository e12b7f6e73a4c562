"""Plain references of the benchmark's configurations, one module a
configuration, named as it is: NumPy in float64 (the exact answers) and
plain PyTorch (the same recursions in a lower precision, the control).
They import nothing of the program: they take the configuration's file and
the observations the benchmark made, and read the program's outputs only
to judge them."""
