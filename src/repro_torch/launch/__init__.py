"""Meshes, parameter and batch placements, and input specs for training
the LM substrate on a `torch.distributed` `DeviceMesh`."""
