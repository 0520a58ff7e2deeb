"""Device pipeline of the port: program, plans, kernels, batch parser."""
