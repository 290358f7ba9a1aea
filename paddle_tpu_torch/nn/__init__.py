"""Neural-network functionals of the port."""
