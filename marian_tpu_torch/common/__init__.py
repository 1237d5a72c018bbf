from .options import Options

__all__ = ["Options"]
