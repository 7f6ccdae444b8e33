"""Data-parallel training over ``torch.distributed``: the mesh
(``mesh.py``) and the collectives of the tick (``collectives.py``)."""
