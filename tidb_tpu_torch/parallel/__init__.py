from .dist import DistCopClient, make_mesh

__all__ = ["DistCopClient", "make_mesh"]
