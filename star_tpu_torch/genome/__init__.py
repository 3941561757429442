from .index import GenomeIndex  # noqa: F401
