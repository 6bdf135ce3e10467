"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version: K1 :mod:`.admm_iter`, K2 :mod:`.spd_inverse`."""
