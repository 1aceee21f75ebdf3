"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the layout helpers around them (counterpart of ``repro.kernels``)."""
