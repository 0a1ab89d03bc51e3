"""Multi-GPU layouts of the port on ``torch.distributed``
(``parallel/mesh.py``)."""
