"""Multi-process synthesis over torch.distributed: the (time, sat) rank
mesh (mesh.py) and cooperative file generation (distributed.py)."""
