"""``fps`` of the traced run's window, in the cells whose host-paced runs
spread too widely for ``fps`` to stand as an end-to-end metric."""
from motbench.measure import reader

read = reader("fps")
