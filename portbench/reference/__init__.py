"""Plain references that decide a run's ``correct``. Nothing here imports
the program, JAX or the JAX package."""
