"""Mesh-sharded encoding for one controlling process: the device
:class:`~h264tpu_torch.parallel.mesh.Mesh`, the row-tile fractal P step
(``tiled_search.py``) and the multi-slot dry run (``dryrun.py``).  The
conformant encoder's band-sharded frame encoders are
``avc/device_enc.py``'s ``make_sharded_encode`` and
``make_sharded_encode_b``."""

from .mesh import Mesh

__all__ = ["Mesh"]
