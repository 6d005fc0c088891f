"""Neural network modules (torch.nn, NCHW / NCDHW inside; JAX layouts at
the public functions)."""
