"""Hand-written Hopper kernels, their plain PyTorch versions and the
device dispatch (counterpart of ``repro.kernels``)."""
