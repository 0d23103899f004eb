from .step import build_grads_step, build_train_step

__all__ = ["build_grads_step", "build_train_step"]
