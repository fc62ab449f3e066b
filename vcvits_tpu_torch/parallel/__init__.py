"""Multi-GPU: the ('data', 'model') layout on torch.distributed (mesh.py),
the tensor-parallel operators (tp.py) and the multi-rank dry run
(dryrun.py)."""
