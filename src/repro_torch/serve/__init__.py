from .engine import ServeEngine, build_decode_step

__all__ = ["ServeEngine", "build_decode_step"]
