from .step import auto_microbatches, build_grads_step, build_train_step

__all__ = ["auto_microbatches", "build_grads_step", "build_train_step"]
