from .profiling import StepTimer, annotate, trace  # noqa: F401
