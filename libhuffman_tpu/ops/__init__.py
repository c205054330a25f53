"""Compute kernels: host-exact reference semantics and their device (JAX,
XLA and Pallas-through-Triton) counterparts."""
