"""Attention kernels of the port: the shared masking core, the plain-torch
oracles, the hand-written Hopper kernels and the backend dispatch."""
