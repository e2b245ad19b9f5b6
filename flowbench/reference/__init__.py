"""The plain reference that decides ``correct``: ``solve.solve`` (see its
module). Imports neither the program nor JAX."""
